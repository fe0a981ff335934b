"""`bp_topk_route_roofline.prefill`: see `portbench.prefill_layers.gate_roofline`."""
from portbench.prefill_layers import gate_roofline as read  # noqa: F401
