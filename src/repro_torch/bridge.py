"""Bridge between the JAX package's parameter pytrees and the port's modules.

JAX random numbers cannot be reproduced in PyTorch, so every parity test
initializes params once (in JAX), converts them to numpy, and hands the
same values to both packages through this module.

The JAX decoder stacks the params of each block-pattern repetition on a
leading group axis (``Decoder.init`` builds ``params["blocks"]`` with
``jax.vmap``) and keeps ``n_layers % len(pattern)`` remainder layers as
``blocks_rem<r>``, run first.  The port holds one :class:`~repro_torch.
models.transformer.Block` per layer, so :func:`from_jax` unstacks the group
axis (remainder layers first, then group ``g``'s pattern slot ``j`` at
``n_rem + g * len(pattern) + j``) and :func:`to_jax` stacks it back.
The encoder-decoder's ``enc_blocks`` and ``dec_blocks`` are vmapped over
their layers (one leading layer axis each): they become
``enc_blocks.<i>.*`` and ``dec_blocks.<i>.*`` and are restacked the same
way.
Only the leading group axis moves: an MoE layer's ``(E, d, f)`` expert
stacks arrive per layer as they are (dead experts included), and the
router keeps its fp32.  A training model (``build_model(..., train=True)``)
takes the same names and holds the values in fp32, as the JAX params are.

The multi-task model's params (``repro.runtime.MTModel.init``: instance
name → nested dicts and lists) map onto the port's instance ``ModuleDict``
by name: :func:`flatten_tree` names a JAX leaf by its path (list indices
included, ``"img_text:contrastive.proj.text"``, ``"vision.layers.0.attn.wq"``),
which is the name ``named_parameters()`` gives the port's leaf
(:func:`load_mt_params`, :func:`mt_params_to_jax`).  Everything here is
numpy: the JAX side converts with ``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import ArchConfig


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A pytree of nested dicts and lists → {dotted path: numpy array}."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return tree


def _pattern(cfg: ArchConfig):
    return tuple(cfg.block_pattern) or ("attn",)


#: the encoder-decoder's layer stacks, one leading layer axis each
LAYER_STACKS = ("enc_blocks", "dec_blocks")


def from_jax(tree: Dict[str, Any], cfg: ArchConfig) -> Dict[str, np.ndarray]:
    """JAX ``Transformer.init`` params (nested dicts of arrays) → the port's
    parameter names and per-layer arrays."""
    pattern = _pattern(cfg)
    L = len(pattern)
    n_rem = cfg.n_layers % L
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "blocks":
            for j in range(L):
                for leaf, arr in flatten_tree(sub[f"p{j}"]).items():
                    for g in range(arr.shape[0]):
                        out[f"decoder.layers.{n_rem + g * L + j}.{leaf}"] = arr[g]
        elif key.startswith("blocks_rem"):
            r = int(key[len("blocks_rem"):])
            for leaf, arr in flatten_tree(sub).items():
                out[f"decoder.layers.{r}.{leaf}"] = arr
        elif key in LAYER_STACKS:
            for leaf, arr in flatten_tree(sub).items():
                for i in range(arr.shape[0]):
                    out[f"{key}.{i}.{leaf}"] = arr[i]
        elif isinstance(sub, dict):
            out.update(flatten_tree(sub, key + "."))
        else:
            out[key] = np.asarray(sub)
    return out


def to_jax(flat: Dict[str, np.ndarray], cfg: ArchConfig) -> Dict[str, Any]:
    """The inverse of :func:`from_jax`: restack the group axis."""
    pattern = _pattern(cfg)
    L = len(pattern)
    n_rem = cfg.n_layers % L
    n_groups = cfg.n_layers // L
    top: Dict[str, np.ndarray] = {}
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    stacks: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for name, arr in flat.items():
        if name.startswith("decoder.layers."):
            _, _, idx, leaf = name.split(".", 3)
            layers.setdefault(int(idx), {})[leaf] = np.asarray(arr)
        elif name.split(".", 1)[0] in LAYER_STACKS:
            key, idx, leaf = name.split(".", 2)
            stacks.setdefault(key, {}).setdefault(int(idx), {})[leaf] = (
                np.asarray(arr))
        else:
            top[name] = np.asarray(arr)
    tree = _unflatten(top)
    for key, per_layer in stacks.items():
        tree[key] = _unflatten({
            leaf: np.stack([per_layer[i][leaf] for i in range(len(per_layer))])
            for leaf in per_layer[0]})
    if not layers:
        return tree
    for r in range(n_rem):
        tree[f"blocks_rem{r}"] = _unflatten(layers[r])
    if n_groups:
        blocks = {}
        for j in range(L):
            idxs = [n_rem + g * L + j for g in range(n_groups)]
            blocks[f"p{j}"] = _unflatten({
                leaf: np.stack([layers[i][leaf] for i in idxs])
                for leaf in layers[idxs[0]]
            })
        tree["blocks"] = blocks
    return tree


def _impl(model):
    return getattr(model, "impl", model)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16 of its own; JAX's bf16 leaves widen to fp32
    # exactly, and load_state casts back to the parameter's dtype
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def load_jax_params(model, tree: Dict[str, Any]):
    """Load JAX params (numpy leaves) into a port model; returns the model."""
    flat = from_jax(tree, model.cfg)
    _impl(model).load_state({k: _to_torch(v) for k, v in flat.items()})
    return model


def jax_params(model) -> Dict[str, Any]:
    """A port model's params as a JAX-layout pytree of numpy arrays (bf16
    parameters are widened to fp32, which numpy can hold exactly)."""
    flat = {}
    for name, p in _impl(model).named_parameters():
        t = p.detach().cpu()
        flat[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return to_jax(flat, model.cfg)


# ---------------------------------------------------------------------------
# Multi-task model params
# ---------------------------------------------------------------------------


def _unflatten_tree(flat: Dict[str, np.ndarray]):
    tree = _unflatten(flat)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


@torch.no_grad()
def load_mt_params(params: torch.nn.ModuleDict, tree: Dict[str, Any]):
    """Copy a JAX ``MTModel.init`` tree (numpy leaves) into the port's
    instance ``ModuleDict``; every leaf of both must match by name and
    shape.  Returns ``params``."""
    flat = flatten_tree(tree)
    named = dict(params.named_parameters())
    if set(flat) != set(named):
        raise KeyError(f"load_mt_params: names differ: "
                       f"{sorted(set(flat) ^ set(named))}")
    for name, p in named.items():
        t = _to_torch(flat[name])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"load_mt_params: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))
    return params


def mt_params_to_jax(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Instance params (or grads) by name — ``dict(params.named_parameters())``
    or the engine's grads — as the JAX MT pytree of numpy arrays."""
    return _unflatten_tree({k: v.detach().cpu().numpy()
                            for k, v in named.items()})
