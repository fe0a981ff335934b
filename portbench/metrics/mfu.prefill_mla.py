"""`mfu.prefill_mla`: see `portbench.prefill_layers.mfu`; the FLOPs are
`roofline/prefill_mla.prefill_flops`'s, carried in the entry's launches."""
from portbench.prefill_layers import mfu as read  # noqa: F401
