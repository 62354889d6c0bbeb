"""Mesh context and sharded layouts of the multi-GPU optimizer step."""
