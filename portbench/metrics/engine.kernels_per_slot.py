"""`engine.kernels_per_slot`: see `portbench.layers.kernels_per_slot`."""
from portbench.layers import kernels_per_slot as read  # noqa: F401
