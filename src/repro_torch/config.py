"""Architecture and kernel-policy configuration (port of ``repro.config``).

``ArchConfig`` and ``MoEConfig`` are field-for-field copies of the JAX
package's, so an architecture has the same numbers in both packages
(``tests/test_torch_imports.py`` pins that for the registered archs).
``ShardingConfig`` keeps the knobs the port reads: ``use_kernels`` (the
JAX package's ``use_pallas``) routes attention and the MoE expert
products through the hand-written CUDA kernels, ``remat`` sets the
training forward's activation checkpoints, ``fsdp``, ``fsdp_over_pod``,
``shard_experts`` and ``seq_shard_acts`` are the sharding rules' knobs
(:mod:`repro_torch.parallel.sharding`), ``logits_chunk`` the vocab loss's
chunk, and ``grad_accum`` and ``accum_dtype`` the placed train step's
microbatching (:mod:`repro_torch.launch.steps`).  ``ShapeConfig``,
``SHAPES`` and :func:`applicable_shapes` are the JAX package's shape
cells.  :func:`resolve_device` is the port's single device policy: asking
for CUDA without a GPU raises, it never falls back.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, List, Tuple

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    pad_to: int = 0

    @property
    def n_physical(self) -> int:
        return max(self.pad_to, self.n_experts)


@dataclass(frozen=True)
class ArchConfig:
    """One architecture.  Field semantics follow ``repro.config.ArchConfig``."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    local_window: int = 0
    moe: MoEConfig = MoEConfig()
    block_pattern: Tuple[str, ...] = ()
    n_ssm_heads: int = 0
    n_enc_layers: int = 0
    frontend_stub_len: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    tie_embeddings: bool = False
    notes: str = ""
    sharding_defaults: Tuple[Tuple[str, object], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(1)-state / windowed decode (long_500k)."""
        return self.family in ("ssm", "hybrid")

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return (d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                + (self.n_heads * hd) * d)

    def _emb_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks): JAX's
        formula, which the dry run's ``model_flops`` reads."""
        d, dff = self.d_model, self.d_ff
        if self.is_moe:
            m = self.moe
            ffn = ((m.n_experts + m.n_shared_experts) * 3 * d * m.d_ff_expert
                   + d * m.n_experts)  # + router
        elif dff > 0:
            ffn = 3 * d * dff
        else:  # xLSTM-style blocks: internal projections ≈ 8·d²
            ffn = 8 * d * d
        per_layer = self._attn_params() + ffn + 2 * d
        return int(per_layer * (self.n_layers + self.n_enc_layers)
                   + self._emb_params())

    def n_active_params(self) -> int:
        """Active (per-token) parameter count — MoE activates top-k only
        (and counts no encoder layer, as JAX's does not)."""
        if not self.is_moe:
            return self.n_params()
        d, m = self.d_model, self.moe
        ffn = ((m.top_k + m.n_shared_experts) * 3 * d * m.d_ff_expert
               + d * m.n_experts)
        per_layer = self._attn_params() + ffn + 2 * d
        return int(per_layer * self.n_layers + self._emb_params())


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(arch: ArchConfig) -> List[str]:
    """Shape cells for an arch per the spec's skip rules (DESIGN.md §5)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.sub_quadratic:
        out.append("long_500k")
    return out


@dataclass(frozen=True)
class ShardingConfig:
    """Kernel and training policy.  ``use_kernels`` swaps the hand-written
    CUDA kernels into the model (flash forward for prefill and training,
    paged decode, the grouped matmul of the MoE experts, the RG-LRU
    scan); on a CPU tensor each kernel wrapper computes its plain PyTorch
    version."""

    use_kernels: bool = False
    # the rules' knobs (``parallel/sharding.py``), JAX's defaults: FSDP over
    # the data axis (and over "pod" too with ``fsdp_over_pod``), experts
    # over "model" (EP; ``moe_apply``'s mesh branch), long activations
    # sequence-sharded over "model"
    fsdp: bool = True
    fsdp_over_pod: bool = False
    shard_experts: bool = True
    seq_shard_acts: bool = True
    # activation checkpoint policy of a training forward: "block" (each
    # block-pattern repetition recomputed in backward) | "sqrt" (JAX's
    # two-level checkpointed groups) | "none"
    remat: str = "block"
    logits_chunk: int = 0  # 0 → 1,024; else the vocab loss's seq chunk
    # Megatron-style sequence parallelism of the residual stream (JAX
    # ``transformer.py:144-170, 327-350``): not ported; a placed step with
    # a model axis > 1 raises (ROADMAP queue 1, item 5g)
    seq_parallel: bool = False
    # the placed train step's microbatch gradient accumulation (1 = off)
    # and its accumulator dtype ("float32" | "bfloat16")
    grad_accum: int = 1
    accum_dtype: str = "float32"


_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _ensure_registered() -> None:
    if not _REGISTRY:
        from . import configs  # noqa: F401  (imports register everything)


def default_sharding(cfg: ArchConfig, **overrides) -> ShardingConfig:
    """The arch's default ShardingConfig: its ``sharding_defaults`` that
    name a field of the port's ShardingConfig (every knob the configs set
    does, ``grad_accum`` and ``accum_dtype`` included), then
    ``overrides``."""
    names = {f.name for f in fields(ShardingConfig)}
    kw = {k: v for k, v in cfg.sharding_defaults if k in names}
    kw.update(overrides)
    return ShardingConfig(**kw)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A smoke-test-sized config of the same family — the exact shrink rule
    of ``repro.config.reduced`` (GQA ratio, qk_norm and pattern kept)."""
    kv_ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_heads = 4
    n_kv = max(n_heads // kv_ratio, 1)
    moe = cfg.moe
    if cfg.is_moe:
        moe = replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_expert=64,
            pad_to=0,
        )
    pattern_len = max(len(cfg.block_pattern), 1)
    small = replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, 2 * pattern_len),
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        moe=moe,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        frontend_stub_len=16 if cfg.frontend_stub_len else 0,
        param_dtype="float32",
        compute_dtype="float32",
        opt_dtype="float32",
    )
    return replace(small, **overrides) if overrides else small


def resolve_device(name: str) -> torch.device:
    """The device a caller asked for.  ``"cuda"`` without a usable GPU
    raises — the port never carries on silently on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
