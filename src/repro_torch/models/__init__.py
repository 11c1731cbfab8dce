"""Model layers of the port (dense and MoE decoders)."""

from .model import Model, build_model  # noqa: F401
