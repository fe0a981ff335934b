"""The fused backpressure top-k gate of MoE routing (bp_topk)."""
