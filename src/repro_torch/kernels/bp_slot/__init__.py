"""The per-slot decision kernels: routing argmax and comp/balance."""
