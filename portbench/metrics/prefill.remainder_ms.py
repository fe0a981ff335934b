"""`prefill.remainder_ms`: see `portbench.prefill_layers.remainder_ms`."""
from portbench.prefill_layers import remainder_ms as read  # noqa: F401
