"""`mfu.prefill`: see `portbench.prefill_layers.mfu`."""
from portbench.prefill_layers import mfu as read  # noqa: F401
