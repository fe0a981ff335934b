"""`bp_topk_route_roofline.prefill_mla`: the sigmoid gate's share of its
roofline, see `portbench.prefill_layers.gate_roofline` (the sigmoid mode
moves the softmax mode's bytes)."""
from portbench.prefill_layers import gate_roofline as read  # noqa: F401
