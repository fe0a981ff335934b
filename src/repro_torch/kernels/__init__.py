"""Hand-written CUDA kernels of the port (one subpackage per kernel family).

Each family has `csrc/*.cu` (the CUDA source, built with nvcc at first CUDA
use by `_build`), `kernel.py` (ctypes wrappers with launch counters; CPU
tensors go to the plain version), `ref.py` (the plain PyTorch versions) and,
where a family has composite entry points, `ops.py`.
"""
