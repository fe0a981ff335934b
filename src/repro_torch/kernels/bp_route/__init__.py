"""The per-link backpressure routing decision (the paper's BP box)."""
