"""Name-based sharding rules: parameter name → partition spec (port of
``repro/parallel/sharding.py``).

A spec is a tuple with one entry per tensor dim, as JAX's
``PartitionSpec``: ``None`` (replicated), a mesh axis name, or a tuple of
names (the dim split over several axes, major to minor).  The rules key
on a parameter's last name component, so they take the port's names
(``decoder.layers.3.mix.wq``) and JAX's (``blocks/p0/mix/wq``) alike.  A
port layer is one :class:`~repro_torch.models.transformer.Block`, with
no stacked group axis (``bridge.py``): the port's spec of a layer leaf is
JAX's spec of the stacked leaf without its leading ``None``.  A dim only
shards if its size divides the axes' size (ragged dims such as 2 KV
heads on a 16-way model axis stay replicated).

Layout summary (MaxText-style):
  * batch dims of activations → ("pod", "data")
  * attention heads / FFN hidden / experts → "model"
  * FSDP: parameter dim 0 additionally sharded over "data"
    (and optionally "pod") when ``ShardingConfig.fsdp`` is on.
  * vocab embedding: vocab dim over "model" (Megatron vocab-parallel).

:func:`placements` turns a spec into DTensor placements, one per mesh
dim.  :func:`place_module` applies the rules to a module: every
parameter becomes a DTensor holding only this rank's block of the whole
leaf (drawn from a seed or handed over whole, e.g. from
``bridge.from_jax``; on a ``"meta"`` device only its shape), and
:func:`gather_data` is the FSDP gather of such a leaf before its layer
uses it.  JAX's ``constrain`` (``with_sharding_constraint``) has no
counterpart: every rank holds local tensors, so GSPMD's layout pins have
nothing to pin.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..config import ShardingConfig
from .collectives import gather_shards
from .mesh import DATA, MODEL, POD, axis_group, axis_size, batch_axes

Spec = Tuple[Any, ...]


def _parts(path: str) -> List[str]:
    return re.split(r"[./]", path)


def _entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: one axis as its name (``PartitionSpec``
    writes ``("data",)`` as ``"data"``), several as the tuple."""
    return axes if len(axes) > 1 else axes[0]


@dataclass
class ShardingRules:
    mesh: Any  # a DeviceMesh, or anything with mesh_dim_names and shape
    cfg: ShardingConfig

    # ------------------------------------------------------------- helpers
    def _axsize(self, axes) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= axis_size(self.mesh, a)
        return n

    def _fits(self, dim: int, axes) -> bool:
        s = self._axsize(axes)
        return s > 1 and dim % s == 0

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        if not self.cfg.fsdp:
            return ()
        names = tuple(self.mesh.mesh_dim_names)
        axes = [DATA] if DATA in names else []
        if self.cfg.fsdp_over_pod and POD in names:
            axes.insert(0, POD)
        return tuple(axes)

    @property
    def batch(self) -> Tuple[str, ...]:
        return batch_axes(self.mesh)

    # --------------------------------------------------------- param rules
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec of the parameter ``path`` of ``shape`` (one layer's leaf:
        no stacked axis)."""
        leaf = _parts(path)[-1]
        dims = tuple(shape)
        nd = len(dims)
        spec: list = [None] * nd

        def model_ok(i: int) -> bool:
            return self._fits(dims[i], MODEL)

        if leaf in ("tok_embed", "pos_embed"):
            if model_ok(0):  # (vocab, d): vocab-parallel over model
                spec[0] = MODEL
        elif leaf in ("lm_head", "wq", "wk", "wv", "w_gate", "w_up"):
            if model_ok(nd - 1):  # vocab / heads / FFN hidden last
                spec[nd - 1] = MODEL
        elif leaf in ("wo", "w_down"):
            if model_ok(0):  # heads / FFN hidden first
                spec[0] = MODEL
        elif leaf in ("we_gate", "we_up", "we_down"):
            # expert-stacked (E, d_in, d_out): EP over model on the experts
            if self.cfg.shard_experts and self._fits(dims[0], MODEL):
                spec[0] = MODEL
            elif not self.cfg.shard_experts:
                # TP fallback: shard the expert FFN's hidden dim instead
                hid = nd - 1 if leaf != "we_down" else 1
                if model_ok(hid):
                    spec[hid] = MODEL
        elif leaf in ("w_in", "w_out", "w_a", "w_x", "w_r", "w_i", "w_f",
                      "w_z", "w_oproj"):
            # recurrent-block projections: the wide dim over model
            wide = int(np.argmax(dims))
            if model_ok(wide):
                spec[wide] = MODEL
        # router, norms, gates, biases, scalars stay replicated

        # FSDP: the first not-yet-sharded dim over the data axes
        fa = self.fsdp_axes
        if fa:
            size = self._axsize(fa)
            for i in range(nd):
                if spec[i] is None and dims[i] % size == 0 and dims[i] >= size:
                    spec[i] = _entry(fa)
                    break
        return tuple(spec)

    # ----------------------------------------------------- activation rules
    def act_btd(self) -> Spec:
        """(batch, seq, d) activations."""
        return (_entry(self.batch), None, None)

    def act_btd_seqsharded(self) -> Spec:
        """(batch, seq, d) with the sequence over model (long contexts)."""
        return (_entry(self.batch), MODEL if self.cfg.seq_shard_acts else None,
                None)

    def tokens(self) -> Spec:
        return (_entry(self.batch), None)

    def logits(self) -> Spec:
        return (_entry(self.batch), None, MODEL)

    def kv_cache(self) -> Spec:
        """(layers, batch, heads, seq, hd): batch over DP, heads over model."""
        return (None, _entry(self.batch), MODEL, None, None)

    def rnn_state(self) -> Spec:
        """(layers, batch, ...) recurrent state: batch over DP."""
        return (None, _entry(self.batch), None)

    def scalar(self) -> Spec:
        return ()

    # ------------------------------------------------------------ batch rules
    def batch_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec of one batch-dict leaf (tokens, labels, embeds, frames):
        the leading dim over the batch axes when it divides them."""
        spec: list = [None] * len(shape)
        if shape and self._fits(shape[0], self.batch):
            spec[0] = _entry(self.batch)
        return tuple(spec)

    # ------------------------------------------------------------ cache rules
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Spec of one decode-cache leaf.  Layouts: stacked KV (G, B, K, S,
        hd) under a ``groups`` path or a ``self_`` / ``cross_`` leaf, per
        layer KV (B, K, S, hd), recurrent states (B, ...).  Batch over DP;
        KV heads over model when divisible, else the sequence
        (flash-decode style split-KV); recurrent widths over model when
        divisible."""
        parts = _parts(path)
        leaf = parts[-1]
        stacked = 1 if ("groups" in parts
                        or leaf.startswith(("self_", "cross_"))) else 0
        spec: list = [None] * len(shape)
        dims = tuple(shape[stacked:])
        if not dims:
            return tuple(spec)

        def set_dim(i: int, axes) -> None:
            spec[stacked + i] = axes

        if self._fits(dims[0], self.batch):
            set_dim(0, _entry(self.batch))
        if leaf in ("k", "v") or leaf.startswith(("self_", "cross_")):
            if len(dims) >= 4:  # (B, K, S, hd)
                if self._fits(dims[1], MODEL):
                    set_dim(1, MODEL)
                elif self._fits(dims[2], MODEL):
                    set_dim(2, MODEL)
        elif leaf == "C":  # (B, H, hd, hd)
            if len(dims) >= 2 and self._fits(dims[1], MODEL):
                set_dim(1, MODEL)
        elif leaf in ("n", "m", "c", "h") and len(dims) >= 2:
            if self._fits(dims[1], MODEL):
                set_dim(1, MODEL)
        elif leaf == "conv" and len(dims) >= 3:
            if self._fits(dims[2], MODEL):
                set_dim(2, MODEL)
        return tuple(spec)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where tensor dim ``i``'s entry names that axis, else
    ``Replicate()``.  A dim split over a tuple of axes shards on each of
    them; DTensor splits it over the mesh dims left to right (major to
    minor), so the tuple must list its axes in mesh order, as every rule
    here does — JAX's order of ``("pod", "data")``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes if a in names]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for p in pos:
            out[p] = Shard(i)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` splits its tensor over, in spec order."""
    out: list = []
    for entry in spec:
        if entry is not None:
            out += [entry] if isinstance(entry, str) else list(entry)
    return tuple(out)


def local_block(x: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``places``: its
    chunk of every ``Shard`` mesh dim, taken major to minor (DTensor's
    layout, JAX's for the divisible dims the rules shard)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(places):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return x


@torch.no_grad()
def place_module(module: nn.Module, rules: "ShardingRules", *, source=None,
                 device=None) -> Dict[str, Spec]:
    """Replace every parameter of ``module`` by a DTensor with the
    placements of its spec under ``rules``, holding only this rank's
    block.  ``source(i, name, param)`` gives parameter ``i`` whole on the
    CPU (a seeded draw, or a tensor carried across by the bridge), so
    every mesh holds blocks of the one model; the block is copied to
    ``device`` (default: the mesh's device type).  On ``"meta"`` nothing
    is drawn: only the local shapes are made.  Returns ``{name: spec}``."""
    mesh = rules.mesh
    dev = torch.device(device or mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    specs: Dict[str, Spec] = {}
    for i, (name, p) in enumerate(list(module.named_parameters())):
        if isinstance(p, DTensor):
            raise ValueError(f"place_module: {name} is placed already")
        spec = specs[name] = rules.param_spec(name, tuple(p.shape))
        whole = (torch.empty(p.shape, dtype=p.dtype, device="meta")
                 if dev.type == "meta" else source(i, name, p))
        place_param(module, name, whole, spec, mesh, dev)
    return specs


@torch.no_grad()
def place_param(module: nn.Module, name: str, whole: torch.Tensor,
                spec: Spec, mesh, device) -> None:
    """Replace parameter ``name`` of ``module`` by a DTensor with the
    placements of ``spec`` on ``mesh``, holding this rank's block of
    ``whole`` (the leaf's logical value) on ``device``."""
    p = module.get_parameter(name)
    places = placements(spec, mesh)
    local = local_block(whole, mesh, places).to(
        device, dtype=p.dtype, copy=True).contiguous()
    owner, leaf = ((module.get_submodule(name.rsplit(".", 1)[0]),
                    name.rsplit(".", 1)[1]) if "." in name
                   else (module, name))
    dt = DTensor.from_local(local, mesh, places, run_check=False,
                            shape=p.shape,
                            stride=torch.empty(p.shape,
                                               device="meta").stride())
    setattr(owner, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))


def gather_data(p) -> torch.Tensor:
    """A placed leaf as its layer uses it: the local tensor of a DTensor
    with every dim split over non-``"model"`` axes all-gathered whole
    over them (:func:`~repro_torch.parallel.collectives.gather_shards`:
    its gradient reduce-scatters back), the ``"model"`` split kept (the
    tensor-parallel layers compute on it).  A plain tensor is returned
    as it is."""
    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dims: Dict[int, list] = {}
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and names[i] != MODEL:
            dims.setdefault(pl.dim, []).append(names[i])
    out = p.to_local()
    for d, axes in dims.items():
        out = gather_shards(out, axis_group(mesh, tuple(axes))[0], d)
    return out


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if _is_shape(leaf) else tuple(leaf.shape)


def _map(fn, tree, prefix: str = ""):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(_map(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], _shape(tree))


def tree_param_specs(rules: ShardingRules, params) -> Dict[str, Spec]:
    """``{name: spec}`` of a flat ``{name: tensor or shape}`` (e.g.
    ``dict(model.impl.named_parameters())`` of a ``"meta"`` build)."""
    return {name: rules.param_spec(name, _shape(p))
            for name, p in params.items()}


def tree_param_shardings(rules: ShardingRules, params) -> Dict[str, tuple]:
    """``{name: (mesh, placements)}``: targets for
    :func:`repro_torch.ckpt.remesh.restore_to_mesh`."""
    return {name: (rules.mesh, placements(spec, rules.mesh))
            for name, spec in tree_param_specs(rules, params).items()}


def tree_batch_specs(rules: ShardingRules, batch):
    return _map(rules.batch_spec, batch)


def tree_cache_specs(rules: ShardingRules, cache):
    """Specs of a decode cache (the port's per-layer list of dicts), leaf
    paths ``/``-joined (``3/k``).  The encoder-decoder's ``self_*`` /
    ``cross_*`` leaves are JAX's stacked (L, B, K, S, hd) leaves one layer
    at a time, and :meth:`ShardingRules.cache_spec` reads those names as
    stacked: each is specced as its stacked form, without the layer
    entry."""
    def spec(path: str, shape):
        if _parts(path)[-1].startswith(("self_", "cross_")):
            return rules.cache_spec(path, (1,) + tuple(shape))[1:]
        return rules.cache_spec(path, shape)

    return _map(spec, cache)
