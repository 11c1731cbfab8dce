"""Entry points of the port: ``serve`` (paged-KV continuous batching)."""
