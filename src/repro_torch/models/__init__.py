"""Model layers of the port (dense decoders)."""

from .model import Model, build_model  # noqa: F401
