"""Deterministic sharded token streams (port of `repro.data`)."""
from .pipeline import DataConfig, TokenStream, unigram_entropy

__all__ = ["DataConfig", "TokenStream", "unigram_entropy"]
