"""Model factory: ArchConfig → the uniform serving and training API (port of
``repro/models/model.py``).

``Model`` takes the JAX package's batch-dict calls — ``prefill(batch)``
with ``batch["tokens"]``, and the stub modality inputs: ``frames`` for the
encoder-decoder (``[audio]``) archs, precomputed patch ``embeds``
prepended to the tokens for the ``[vlm]`` archs — and forwards to the
model it holds as ``impl``: an :class:`~repro_torch.models.encdec.
EncDecTransformer` when ``cfg.is_encdec``, else a :class:`Transformer`.
Every family of the JAX package is ported; :func:`build_model` refuses a
mixing kind that is not.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ArchConfig, ShardingConfig, resolve_device
from .encdec import EncDecTransformer
from .transformer import KINDS, Transformer, resolve_pattern

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")  # ported


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig,
                 device: torch.device, *, train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.device = device
        impl = EncDecTransformer if cfg.is_encdec else Transformer
        self.impl = impl(cfg, shcfg, device, train=train)

    def init(self, seed: int) -> "Model":
        self.impl.init(seed)
        return self

    def load_state(self, tensors: Dict[str, torch.Tensor]) -> "Model":
        self.impl.load_state(tensors)
        return self

    def loss(self, batch, *, mesh=None):
        """(loss, {"nll", "aux"}) of a batch dict (see
        :meth:`Transformer.loss` and :meth:`EncDecTransformer.loss`).
        ``mesh`` reaches a decoder's MoE layers (expert parallelism) and a
        placed model's layers (tensor parallelism over ``"model"``)."""
        return self.impl.loss(batch, mesh=mesh)

    def _enc_len(self, cache_len: int, enc_len: int) -> int:
        return enc_len or max(cache_len // 4, 1)

    def prefill(self, batch, *, cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, mesh=None):
        if self.cfg.is_encdec:
            return self.impl.prefill(batch["tokens"], batch["frames"],
                                     cache_len=cache_len,
                                     cache_dtype=cache_dtype, mesh=mesh)
        return self.impl.prefill(batch["tokens"], batch.get("embeds"),
                                 cache_len=cache_len, cache_dtype=cache_dtype,
                                 mesh=mesh)

    def init_cache(self, batch: int, cache_len: int, *, enc_len: int = 0,
                   cache_dtype=torch.bfloat16):
        """The slab decode cache (``enc_len`` 0 → ``cache_len // 4``)."""
        if self.cfg.is_encdec:
            return self.impl.init_cache(
                batch, cache_len, self._enc_len(cache_len, enc_len),
                cache_dtype)
        return self.impl.init_cache(batch, cache_len, cache_dtype)

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, enc_len: int = 0,
                         cache_dtype=torch.bfloat16):
        """Paged decode cache + per-leaf layout codes."""
        if self.cfg.is_encdec:
            return self.impl.init_paged_cache(
                batch, cache_len, self._enc_len(cache_len, enc_len),
                n_pages=n_pages, page_size=page_size, cache_dtype=cache_dtype)
        return self.impl.init_paged_cache(
            batch, cache_len, n_pages=n_pages, page_size=page_size,
            cache_dtype=cache_dtype,
        )

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill rebuilds attention state from the KV pool chunk
        by chunk — only all-attention decoder-only stacks qualify."""
        return self.impl.supports_chunked_prefill

    def decode_step(self, token, cache, pos, *, pages=None, mesh=None,
                    seq_cache: bool = False):
        return self.impl.decode_step(token, cache, pos, pages=pages,
                                     mesh=mesh, seq_cache=seq_cache)

    def prefill_chunk(self, tokens, cache, pos0: int, *, pages, mesh=None):
        return self.impl.prefill_chunk(tokens, cache, pos0, pages=pages,
                                       mesh=mesh)


def build_model(cfg: ArchConfig, shcfg: Optional[ShardingConfig] = None, *,
                device: str = "cuda", train: bool = False) -> Model:
    """A model with uninitialized weights on ``device`` (fill it with
    :meth:`Model.init` or :meth:`Model.load_state`).  The dense, MoE,
    ssm, hybrid and VLM decoders (mixing kinds ``attn``, ``local_attn``,
    ``rglru``, ``mlstm`` and ``slstm``) and the encoder-decoder are ported.
    ``train=True`` gives the training layout (fp32 masters with gradients,
    a cast per layer)."""
    pattern = resolve_pattern(cfg)
    if cfg.family not in FAMILIES or not set(pattern) <= set(KINDS):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, pattern {pattern}): only the "
            f"{FAMILIES} families over the mixing kinds {KINDS} are ported")
    return Model(cfg, shcfg or ShardingConfig(), resolve_device(device),
                 train=train)
