"""Carry problems, queue state and model weights across from numpy.

What has to match the reference are the problem constants, the queue
state and, for the models, the weights (for training, the whole train
state).  A caller (the parity tests) turns
the reference's objects into dicts of numpy arrays with `np.asarray`, and
these functions build the port's tensors from them — the port itself never
sees a jax object.  Like every entry point they put their tensors on CUDA
unless the caller passes ``device`` (`repro_torch.device.resolve_device`),
and raise without a card.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.queues import NetState
from repro_torch.device import resolve_device
from repro_torch.fleet.batching import LEAVES, PaddedProblem
from repro_torch.kernels.bp_slot.ref import STATE_LEAVES as STATE_FIELDS
from repro_torch.optim import AdamWState, EFState
from repro_torch.runtime.step import TrainState

#: Leaf -> rank of one unbatched problem's leaf.
_PROBLEM_RANK = {"edges": 2, "edge_cap": 1, "s1": 0, "s2": 0, "dest": 0,
                 "comp_nodes": 1, "comp_caps": 1, "sink": 3, "edge_mask": 1,
                 "comp_mask": 1}
_STATE_RANK = {"Q": 3, "Ddum": 2, "X": 2, "Y": 1, "H": 1, "cum_arr": 2,
               "cum_comb": 1, "delivered": 0, "delivered_useful": 0,
               "delivered_c": 0, "delivered_useful_c": 0}


def _batched(name: str, a: np.ndarray, rank: int) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == rank:
        return a[None]
    if a.ndim != rank + 1:
        raise ValueError(f"{name}: expected rank {rank} or {rank + 1} "
                         f"(batched), got shape {a.shape}")
    return a


def padded_problem_from_numpy(leaves: Dict[str, np.ndarray], n_nodes: int,
                              n_comp: int, device=None) -> PaddedProblem:
    """A PaddedProblem from numpy leaves named as its fields; unbatched
    leaves (one problem) become a batch of one."""
    missing = set(LEAVES) - set(leaves)
    if missing:
        raise KeyError(f"missing problem leaves: {sorted(missing)}")
    dev = resolve_device(device)
    return PaddedProblem(n_nodes=int(n_nodes), n_comp=int(n_comp), **{
        k: torch.as_tensor(np.array(_batched(k, leaves[k], _PROBLEM_RANK[k])),
                           device=dev)
        for k in LEAVES})


def net_state_from_numpy(d: Dict[str, np.ndarray], device=None) -> NetState:
    """A NetState from numpy arrays named as its fields; unbatched arrays
    (one sim) become a batch of one."""
    missing = set(STATE_FIELDS) - set(d)
    if missing:
        raise KeyError(f"missing state fields: {sorted(missing)}")
    dev = resolve_device(device)
    return NetState(**{
        k: torch.as_tensor(_batched(k, d[k], _STATE_RANK[k]).astype(
            np.float32), device=dev)
        for k in STATE_FIELDS})


def net_state_to_numpy(state: NetState) -> Dict[str, np.ndarray]:
    """The state's fields as batched numpy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}


def params_from_numpy(tree, device=None):
    """A model's parameters from the reference's value tree (after
    `split_tree`) with every leaf turned into a numpy array: nested dicts
    of tensors of the same names, shapes and dtypes, on ``device`` (a
    None subtree, a parameter-free norm, stays None)."""
    dev = resolve_device(device)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return None if t is None else torch.as_tensor(np.array(t),
                                                      device=dev)
    return build(tree)


def train_state_from_numpy(state, device=None):
    """The port's `runtime.step.TrainState` from the reference's, every
    leaf turned into a numpy array (``jax.tree_util.tree_map(np.asarray,
    state)``, which keeps its NamedTuples): params, AdamW count and
    moments, step, router queues and error-feedback residuals (the last
    two may be None), on ``device``."""
    dev = resolve_device(device)
    tensor = lambda a: torch.as_tensor(np.array(a), device=dev)
    return TrainState(
        step=tensor(state.step),
        params=params_from_numpy(state.params, dev),
        opt=AdamWState(count=tensor(state.opt.count),
                       m=params_from_numpy(state.opt.m, dev),
                       v=params_from_numpy(state.opt.v, dev)),
        router_H=None if state.router_H is None else tensor(state.router_H),
        ef=None if state.ef is None else EFState(
            err=params_from_numpy(state.ef.err, dev)))
