"""Launchers of the port: `serve` (continuous-batching LLM serving) and
`train` (the end-to-end training driver)."""
