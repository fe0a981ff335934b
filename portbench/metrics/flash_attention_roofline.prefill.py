"""`flash_attention_roofline.prefill`: see `portbench.prefill_layers.flash_roofline`."""
from portbench.prefill_layers import flash_roofline as read  # noqa: F401
