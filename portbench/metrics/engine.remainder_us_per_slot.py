"""`engine.remainder_us_per_slot`: see `portbench.layers.remainder_us_per_slot`."""
from portbench.layers import remainder_us_per_slot as read  # noqa: F401
