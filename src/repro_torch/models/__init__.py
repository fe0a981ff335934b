"""LLM substrate of the port: dense (with Gemma's local/global pattern)
and MoE decoder-only transformers (`transformer`), the Mamba2 +
shared-attention hybrid (`zamba`, over `mamba`), xLSTM (`xlstm`), the VLM
(`vlm`) and the encoder-decoder (`encdec`): init, loss, the prefill
forward and decode through the uniform `ModelAPI`."""
from .api import ModelAPI, get_model
from .common import Annotated, Init, split_tree

__all__ = ["ModelAPI", "get_model", "Annotated", "Init", "split_tree"]
