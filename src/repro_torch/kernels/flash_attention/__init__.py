"""Flash attention: blockwise online softmax with GQA, causal and window
masks (the train/prefill attention core)."""
