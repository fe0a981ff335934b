"""LLM substrate of the port: dense and MoE decoder-only transformers, the
prefill forward (`transformer.lm_logits`) and the decode path
(`transformer.lm_decode_step`) through the uniform `ModelAPI`."""
from .api import ModelAPI, get_model
from .common import Annotated, Init, split_tree

__all__ = ["ModelAPI", "get_model", "Annotated", "Init", "split_tree"]
