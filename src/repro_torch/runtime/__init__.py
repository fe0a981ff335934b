"""Step builders of the port (`runtime.step`): prefill and serve."""
