"""`bp_slot_step_roofline.trace`: see `portbench.layers.slot_kernel_roofline`."""
from portbench.layers import slot_kernel_roofline as read  # noqa: F401
