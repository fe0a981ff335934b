"""Launchers of the port: `serve` (continuous-batching LLM serving)."""
