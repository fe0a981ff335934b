"""Device selection and the pytree helpers the batched state needs.

Every entry point (`run_fleet`, `stream_simulate`, `simulate`,
`sweep_rates`, `capacity_report`) runs on CUDA unless its caller passes
``device="cpu"``.  Without a card and without an explicit device they
raise: a run never carries on on the CPU by accident.

The state containers are frozen dataclasses whose fields are tensors or
other such dataclasses; `tree_leaves` walks them the way `jax.tree_util`
walks the JAX package's NamedTuples.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None, abstract: bool = False) -> torch.device:
    """The device an entry point runs on: the meta device when
    ``abstract`` (shapes and dtypes, no storage: the dry-run's state),
    else ``device`` when given, else CUDA.

    Raises RuntimeError when no device was asked for and CUDA is absent."""
    if abstract:
        if device is not None:
            raise ValueError(f"abstract state lives on the meta device, not "
                             f"{device}")
        return torch.device("meta")
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return torch.device("cuda")


def upload(array, device, dtype=None) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  To a card it goes through
    pinned memory without blocking: a copy from pageable memory would
    make the host wait for all the work queued on the stream (PyTorch
    synchronises the stream after one)."""
    if device is None or torch.device(device).type != "cuda":
        return torch.as_tensor(array, dtype=dtype, device=device)
    host = torch.as_tensor(array, dtype=dtype)
    return host.pin_memory().to(device, non_blocking=True)


def tree_leaves(x) -> list:
    """The tensors of a tree of dataclasses, in field order."""
    if not dataclasses.is_dataclass(x):
        return [x]
    out = []
    for f in dataclasses.fields(x):
        out.extend(tree_leaves(getattr(x, f.name)))
    return out
