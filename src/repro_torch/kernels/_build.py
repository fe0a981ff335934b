"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 <flags>
         -shared -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <src>

where ``<flags>`` are the source's own (`SOURCE_FLAGS`, by file name):

  * ``bp_slot.cu``, ``bp_slot_step.cu``, ``bp_topk.cu``,
    ``bp_topk_route.cu``, ``bp_route.cu``, ``counter_hash.cu``:
    ``-fmad=false``, and no ``--use_fast_math``.  Both are part of these
    kernels' bit-exactness contract: their plain versions spell every
    rounding, and a contracted multiply-add would round once where they
    round twice (see the sources).
  * ``flash_attention.cu``, ``flash_attention_sm90.cu``: none but
    ``-Xptxas -v`` (registers, shared memory and spills, kept in the
    build log).  Flash attention agrees with its plain version to
    rounding, not bit for bit, so its multiply-adds may fuse.

Libraries go to ``build/repro_torch/`` at the checkout's root (listed in
.gitignore), named by a hash of the source, the headers (``*.cuh``) of its
directory and its flags, so an edited source, header or flag is rebuilt
and an unchanged one is reused; nvcc's output and its wall seconds
go beside it as ``<name>-<hash>.log``.  Nothing is built when a module
is imported: `load` builds at a kernel's first CUDA call, and `build_all`
builds every source up front, one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

from ..obs import spans

PKG_ROOT = pathlib.Path(__file__).resolve().parents[1]      # src/repro_torch
BUILD_DIR = PKG_ROOT.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: The build log's last line: this, then nvcc's wall seconds.
NVCC_SECONDS = "nvcc wall seconds:"
#: Each source's flags beside NVCC_FLAGS, by file name (see the docstring).
SOURCE_FLAGS = {
    "bp_slot.cu": ("-fmad=false",),
    "bp_slot_step.cu": ("-fmad=false",),
    "bp_topk.cu": ("-fmad=false",),
    "bp_topk_route.cu": ("-fmad=false",),
    "bp_route.cu": ("-fmad=false",),
    "counter_hash.cu": ("-fmad=false",),
    "flash_attention.cu": ("-Xptxas", "-v"),
    "flash_attention_sm90.cu": ("-Xptxas", "-v"),
}

_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[pathlib.Path, threading.Lock] = {}
_LOADED: Dict[pathlib.Path, ctypes.CDLL] = {}


def sources() -> List[pathlib.Path]:
    """Every CUDA source of the port, in a stable order."""
    return sorted(PKG_ROOT.glob("kernels/**/csrc/*.cu"))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built at first use on a CUDA machine")
    return found


def flags(src: pathlib.Path) -> tuple:
    """The nvcc flags of one source: NVCC_FLAGS and its SOURCE_FLAGS."""
    name = pathlib.Path(src).name
    if name not in SOURCE_FLAGS:
        raise KeyError(f"{name}: no entry in _build.SOURCE_FLAGS")
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(src)).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: pathlib.Path) -> pathlib.Path:
    """The library of one source, compiled first if it is not there."""
    out = library_path(src)
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(src, threading.Lock())
    with lock:                    # one build per source; sources in parallel
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *flags(src), "-o", tmp, str(src)]
        t0 = time.perf_counter()
        with spans.span("kernel.build"):
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        out.with_suffix(".log").write_text(
            f"{proc.stdout}{NVCC_SECONDS} {secs:.2f}\n")
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    return out


def build_all() -> float:
    """Build every source, all nvcc processes at once; returns the wall
    seconds spent."""
    t0 = time.perf_counter()
    srcs = sources()
    with ThreadPoolExecutor(max_workers=max(len(srcs), 1)) as pool:
        for fut in [pool.submit(build, src) for src in srcs]:
            fut.result()
    return time.perf_counter() - t0


def load(src: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    src = pathlib.Path(src)
    lib = _LOADED.get(src)
    if lib is None:
        with spans.span("kernel.load"):
            path = build(src)
            with _LOCK:
                lib = _LOADED.get(src)
                if lib is None:
                    lib = _LOADED[src] = ctypes.CDLL(str(path))
    return lib
