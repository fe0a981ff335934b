"""PyTorch/CUDA port of the backpressure network-computation system.

A package beside the JAX reference `repro`, with the same subpackage and
module names (`core`, `kernels.bp_slot`, `sim`, `fleet`).  It imports
torch, numpy and scipy, never jax and nothing of `repro`.  Every state
tensor carries a leading fleet axis [B]; the per-slot decisions run in
hand-written CUDA kernels on the card (`kernels/bp_slot/csrc/bp_slot.cu`)
and in their plain PyTorch versions on the CPU.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
