"""Fault-tolerant checkpointing: atomic manifests, keep-last-k, a background
save thread, per-leaf integrity checksums.

Port of `repro.checkpoint.checkpointer`, on the port's own trees: frozen
dataclasses, NamedTuples, dicts, tuples, lists and tensors (numpy arrays
and Python scalars are leaves too; None is an empty subtree).

Layout:  <dir>/step_<N:08d>/ {manifest.json, arr_<i>.npy ...}
Writes go to a tmp dir (manifest fsync'd), then one os.replace() moves the
step into place, so a crash mid-save never corrupts the latest checkpoint.
The manifest carries a sha256 per array (dtype, then shape, then bytes,
as the reference hashes them, so equal arrays give equal digests in both
packages), verified on restore: a torn write is detected, and
`restore(..., fallback=True)` walks back to the newest intact step.

`save` copies every tensor leaf to host memory before it returns (a copy,
never a view of a buffer the caller reuses), so the caller may overwrite
its tensors at once; only the disk write and the digests may run on the
background thread.  bfloat16 leaves are stored as their uint16 bits with
``"bfloat16"`` in the manifest's ``dtypes``.

Beyond the tree, a checkpoint can carry an ``extra`` JSON payload (the
engines' host-side scheduler state, `runtime.resilience`) inside the
manifest, under the same atomic publish.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruption(RuntimeError):
    """A checkpoint step exists on disk but fails integrity verification
    (missing arrays, checksum mismatch, unreadable manifest)."""


def _sha256(a: np.ndarray) -> str:
    # Hash dtype+shape+bytes: a reinterpreted or reshaped array must not
    # collide with the original.
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, structure): the leaves in a fixed order (dataclass and
    NamedTuple fields in order, dict keys sorted, sequence items in order)
    and a string naming the tree's structure, which `restore` checks."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            parts = [f"{f.name}={walk(getattr(x, f.name))}"
                     for f in dataclasses.fields(x)]
            return f"{type(x).__name__}({','.join(parts)})"
        if _is_namedtuple(x):
            parts = [f"{k}={walk(v)}" for k, v in zip(x._fields, x)]
            return f"{type(x).__name__}({','.join(parts)})"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k!r}:{walk(x[k])}"
                                  for k in sorted(x)) + "}"
        if isinstance(x, (tuple, list)):
            inner = ",".join(walk(v) for v in x)
            return f"({inner},)" if isinstance(x, tuple) else f"[{inner}]"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def unflatten(like, leaves: List[Any]):
    """``like``'s structure with its leaves replaced by ``leaves``."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: build(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        return next(it)

    return build(like)


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name): a host copy of one leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).cpu().numpy().view(np.uint16)
            return bits.copy(), "bfloat16"
        a = x.cpu().numpy().copy()
        return a, str(a.dtype)
    a = np.array(x)                      # a copy, also of numpy arrays
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, like):
    """The stored array ``a`` as a leaf shaped like ``like``: a tensor on
    ``like``'s device for a tensor, else the array."""
    a = np.array(a, order="C")        # keeps 0-d arrays 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(a)
    else:
        return a
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # Milliseconds of the last save's phases: the host copy, the
        # digests and the disk write (the last two set once written).
        self.last_ms: dict = {}

    # ---- save -------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = True,
             extra: dict | None = None) -> None:
        """Snapshot to host memory synchronously; write to disk (optionally
        in the background so the caller keeps stepping).  ``extra`` is an
        arbitrary JSON-serializable payload published atomically with the
        arrays (inside the manifest)."""
        t0 = time.perf_counter()
        flat, structure = flatten(state)
        host = [_to_host(x) for x in flat]        # device -> host snapshot
        self.last_ms = {"copy": (time.perf_counter() - t0) * 1e3}
        if self._thread is not None:
            self._thread.join()                   # one in-flight save max
            self._thread = None
        if blocking:
            self._write(step, host, structure, extra)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, structure, extra),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, structure: str,
               extra: dict | None = None) -> None:
        """Atomic publish: arrays + manifest land in a tmp dir, then one
        `os.replace` renames the whole step into place, so a reader never
        sees a partly written step and a crash mid-write leaves only a
        `.tmp_*` dir the next save of that step removes.  Only the manifest
        is fsync'd: a killed process cannot tear page-cache writes, and a
        power loss that tears array data is detected by the per-array
        sha256 on restore, which then falls back to the newest intact
        step."""
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        t0 = time.perf_counter()
        sums = [_sha256(a) for a, _ in host]
        t1 = time.perf_counter()
        manifest = {"step": step, "n_arrays": len(host),
                    "treedef": structure, "time": time.time(),
                    "dtypes": [d for _, d in host],
                    "shapes": [list(a.shape) for a, _ in host],
                    "sha256": sums, "extra": extra}
        for i, (a, _) in enumerate(host):
            with open(tmp / f"arr_{i}.npy", "wb") as f:
                np.save(f, a)
                f.flush()
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                    # atomic publish
        self._gc()
        self.last_ms.update(sha256=(t1 - t0) * 1e3,
                            write=(time.perf_counter() - t1) * 1e3)

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore ----------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_verified(self, step: int) -> tuple[dict, list[np.ndarray]]:
        """Read one step's manifest + arrays, verifying per-leaf sha256.

        Raises `CheckpointCorruption` on any integrity failure so callers
        can fall back to an older step."""
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruption(f"{d}: unreadable manifest ({e})")
        arrays: list[np.ndarray] = []
        sums = manifest.get("sha256")
        for i in range(manifest["n_arrays"]):
            p = d / f"arr_{i}.npy"
            try:
                a = np.load(p)
            except (OSError, ValueError) as e:
                raise CheckpointCorruption(f"{p}: unreadable array ({e})")
            if sums is not None:        # pre-checksum checkpoints: skip
                if _sha256(a) != sums[i]:
                    raise CheckpointCorruption(
                        f"{p}: sha256 mismatch (torn write / bit rot)")
            arrays.append(a)
        return manifest, arrays

    def extra(self, step: Optional[int] = None) -> dict | None:
        """The ``extra`` JSON payload of a step (default: latest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return manifest.get("extra")

    def restore(self, like: Any, step: Optional[int] = None,
                fallback: bool = False, into: Any = None) -> Any:
        """Restore into the structure of ``like``.

        With ``into`` (a tree of existing tensors of that structure, say
        the static carry a captured CUDA graph reads), every stored array
        is written into its tensor in place with ``copy_`` and ``into`` is
        returned; nothing is rebound.  Without it, new tensors are built
        on the devices of ``like``'s tensors.  (The reference's
        ``shardings`` has no counterpart: the port runs on one device.)

        Every array's sha256 is verified against the manifest.  With
        ``fallback=True`` a corrupt or partial step is skipped and the
        next-newest intact step is restored instead (a crash mid-publish
        costs at most one snapshot interval, never the run); without it,
        corruption raises `CheckpointCorruption`."""
        steps = ([step] if step is not None
                 else sorted(self.all_steps(), reverse=True))
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in steps:
            try:
                manifest, arrays = self._load_verified(s)
                break
            except CheckpointCorruption as e:
                last_err = e
                if not fallback:
                    raise
        else:
            raise CheckpointCorruption(
                f"no intact checkpoint in {self.dir}: {last_err}")
        flat_like, structure = flatten(into if into is not None else like)
        if manifest["n_arrays"] != len(flat_like) or \
                manifest.get("treedef") not in (None, structure):
            raise ValueError(f"step {s}: structure mismatch: "
                             f"{manifest.get('treedef')} != {structure}")
        leaves = []
        for a, dt, l in zip(arrays, manifest["dtypes"], flat_like):
            if tuple(a.shape) != tuple(np.shape(l)):
                raise ValueError(f"step {s}: shape {a.shape} != "
                                 f"{tuple(np.shape(l))}")
            leaves.append(_from_host(a, dt, l))
        if into is None:
            return unflatten(like, leaves)
        for dst, src in zip(flat_like, leaves):
            if not isinstance(dst, torch.Tensor):
                raise TypeError(f"restore(into=...) needs tensors, got "
                                f"{type(dst).__name__}")
            dst.copy_(src)
        return into

    def restored_step(self, step: Optional[int] = None,
                      fallback: bool = False) -> Optional[int]:
        """The step `restore` would actually load: ``step`` (or the
        latest) unless fallback walks past corruption.  None if nothing
        intact exists."""
        steps = ([step] if step is not None
                 else sorted(self.all_steps(), reverse=True))
        for s in steps:
            try:
                self._load_verified(s)
                return s
            except CheckpointCorruption:
                if not fallback:
                    raise
        return None
