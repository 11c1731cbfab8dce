"""Model factory: ArchConfig → the uniform serving API (port of
``repro/models/model.py``, decoder-only).

``Model`` takes the JAX package's batch-dict calls — ``prefill(batch)``
with ``batch["tokens"]`` — and forwards to the :class:`Transformer` it
holds as ``impl``; the encoder-decoder and frontend-stub families it would
also dispatch to, and the xLSTM mixers, come with their slices, and
:func:`build_model` refuses them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ArchConfig, ShardingConfig, resolve_device
from .transformer import KINDS, Transformer, resolve_pattern


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig,
                 device: torch.device, *, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.device = device
        self.impl = Transformer(cfg, shcfg, device, train=train)

    def init(self, seed: int) -> "Model":
        self.impl.init(seed)
        return self

    def load_state(self, tensors: Dict[str, torch.Tensor]) -> "Model":
        self.impl.load_state(tensors)
        return self

    def loss(self, batch):
        """(loss, {"nll", "aux"}) of a batch dict (see
        :meth:`Transformer.loss`)."""
        return self.impl.loss(batch)

    def prefill(self, batch, *, cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16):
        return self.impl.prefill(batch["tokens"], cache_len=cache_len,
                                 cache_dtype=cache_dtype)

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, cache_dtype=torch.bfloat16):
        """Paged decode cache + per-leaf layout codes."""
        return self.impl.init_paged_cache(
            batch, cache_len, n_pages=n_pages, page_size=page_size,
            cache_dtype=cache_dtype,
        )

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill rebuilds attention state from the KV pool chunk
        by chunk — only all-attention stacks qualify."""
        return self.impl.supports_chunked_prefill

    def decode_step(self, token, cache, pos, *, pages=None):
        return self.impl.decode_step(token, cache, pos, pages=pages)

    def prefill_chunk(self, tokens, cache, pos0: int, *, pages):
        return self.impl.prefill_chunk(tokens, cache, pos0, pages=pages)


def build_model(cfg: ArchConfig, shcfg: Optional[ShardingConfig] = None, *,
                device: str = "cuda", train: bool = False) -> Model:
    """A model with uninitialized weights on ``device`` (fill it with
    :meth:`Model.init` or :meth:`Model.load_state`).  The dense, MoE and
    hybrid decoders are ported, with the mixing kinds ``attn``,
    ``local_attn`` and ``rglru``.  ``train=True`` gives the training
    layout (fp32 masters with gradients, a cast per layer)."""
    pattern = resolve_pattern(cfg)
    if (cfg.family not in ("dense", "moe", "hybrid") or cfg.is_encdec
            or not set(pattern) <= set(KINDS)):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, pattern {pattern}): only dense, MoE "
            f"and hybrid decoders over the mixing kinds {KINDS} are ported; "
            f"the rest waits for ROADMAP queue 1, item 4 (slab layout and "
            f"the other families)")
    return Model(cfg, shcfg or ShardingConfig(), resolve_device(device),
                 train=train)
