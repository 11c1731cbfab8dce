"""Sharded npz checkpoints with a JSON manifest: atomic, step-addressed,
keep-last-k, auto-resumable (port of ``repro/ckpt/checkpoint.py``, the same
on-disk format: either package reads what the other wrote).

Layout::

    <dir>/step_000123/
        manifest.json    # step, tree structure, dtypes, shapes, extra meta
        shard_00000.npz  # flattened leaves, chunked ≤ ``shard_bytes``

Leaves are named by their ``/``-joined path (``/`` becomes ``%`` in an npz
key).  The tree may hold nested ``dict`` / ``list`` / ``tuple``, tensors,
numpy arrays and Python scalars, an ``nn.Module`` (its
``named_parameters()``, each dotted name a path) and an
:class:`repro_torch.optim.OptState` (``mu/…``, ``nu/…`` keyed like the
params, and ``count`` as a 0-d int32 leaf, as JAX stores it).  Dicts
flatten in sorted key order, as JAX's tree utilities do.  A bf16 leaf is
stored as a ``uint16`` view with ``"dtype": "bfloat16"`` (no ``ml_dtypes``:
the bits go through ``torch.int16``).

Durability contract: writes go to ``step_XXXX.tmp`` and are published by
rename; re-saving an existing step parks the old directory at
``step_XXXX.old`` until the new one is in place, so there is no window in
which the previously restorable step is gone.  ``all_steps`` and
``latest_step`` only count directories whose manifest parses and whose
shard files all exist — a crash mid-save (or a truncated copy) can never
yield an unrestorable "latest" checkpoint.

With ``shard_groups=N`` the flattened leaves are partitioned round-robin
into N shard sequences (one per device group); :func:`load_shard_group`
reads one group's files only.  The manifest layout stays host-count
independent.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import OptState

_STEP_RE = re.compile(r"^step_(\d{9})$")

#: dtypes numpy cannot hold → (manifest name, the signed integer dtype of
#: their bits in torch and in numpy, the unsigned view stored in the npz)
_BITCAST = {
    torch.bfloat16: ("bfloat16", torch.int16, np.int16, np.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.int8, np.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.int8, np.int8, np.uint8),
}
_BITCAST_BY_NAME = {v[0]: (dt, v[2]) for dt, v in _BITCAST.items()}


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


class HostTree(list):
    """A tree already flattened to host memory: ``(name, array, dtype
    name)`` triples (what :class:`repro_torch.ckpt.AsyncCheckpointManager`
    copies on the step turn); saved as it is."""


def _items(node) -> Optional[List[Tuple[str, Any]]]:
    """The named children of an inner node, or ``None`` for a leaf."""
    if isinstance(node, torch.nn.Module):
        return [(n.replace(".", "/"), p) for n, p in node.named_parameters()]
    if isinstance(node, OptState):  # moments keyed by parameter path
        return ([(f"mu/{k.replace('.', '/')}", v) for k, v in node.mu.items()]
                + [(f"nu/{k.replace('.', '/')}", v)
                   for k, v in node.nu.items()]
                + [("count", np.asarray(node.count, np.int32))])
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=str)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in flatten order (``"leaf"`` for a bare leaf)."""
    items = _items(tree)
    if items is None:
        return [(prefix[:-1] or "leaf", tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten_with_names(v, f"{prefix}{k}/"))
    return out


def _to_numpy(leaf, *, copy: bool = False) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array to store, manifest dtype name).  ``copy``
    makes the array independent of the live leaf: a CPU tensor's
    ``.numpy()`` and a numpy leaf would otherwise alias it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.to("cpu", copy=True) if copy else t.cpu()
        if t.dtype in _BITCAST:
            name, view, _, store = _BITCAST[t.dtype]
            return t.view(view).numpy().view(store), name
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True) if copy else np.asarray(leaf)
    return arr, str(arr.dtype)


def host_leaves(tree, *, copy: bool = False) -> HostTree:
    """``tree`` flattened to host numpy: ``(name, array, dtype name)``."""
    if isinstance(tree, HostTree):
        return tree
    return HostTree((name, *_to_numpy(leaf, copy=copy))
                    for name, leaf in _flatten_with_names(tree))


def save_checkpoint(
    base: str,
    step: int,
    tree,
    *,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
    shard_bytes: int = 1 << 30,
    shard_groups: int = 0,
) -> str:
    """Atomically save ``tree`` at ``step``; prune to the newest ``keep``.

    ``shard_groups > 0`` partitions the leaves round-robin into that many
    independent shard sequences (one per device group) so no single host
    has to serialize the whole tree.
    """
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    named = host_leaves(tree)
    groups = max(0, int(shard_groups))
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "shard_groups": groups,
        "leaves": [],
        "shards": [],
        "group_shards": {},
    }
    buckets = [named] if groups == 0 else [
        [nl for i, nl in enumerate(named) if i % groups == g]
        for g in range(groups)
    ]
    for g, bucket in enumerate(buckets):
        gkey = str(g)
        manifest["group_shards"][gkey] = []
        shard_idx, shard_cur, shard_size = 0, {}, 0

        def flush():
            nonlocal shard_idx, shard_cur, shard_size
            name = _write_shard(tmp, g, shard_idx, shard_cur)
            manifest["shards"].append(name)
            manifest["group_shards"][gkey].append(name)
            shard_idx, shard_cur, shard_size = shard_idx + 1, {}, 0

        for name, arr, dtype_name in bucket:
            manifest["leaves"].append(
                {
                    "name": name,
                    "shape": list(arr.shape),
                    "dtype": dtype_name,
                    "shard": len(manifest["shards"]),  # next flush's slot
                    "group": g,
                }
            )
            shard_cur[name.replace("/", "%")] = arr
            shard_size += arr.nbytes
            if shard_size >= shard_bytes:
                flush()
        if shard_cur or not manifest["group_shards"][gkey]:
            flush()

    _write_manifest(tmp, manifest)
    _publish(tmp, final)
    _prune(base, keep)
    return final


def _write_shard(tmp: str, group: int, idx: int,
                 arrays: Dict[str, np.ndarray]) -> str:
    name = (f"shard_{idx:05d}.npz" if group == 0
            else f"shard_g{group:03d}_{idx:05d}.npz")
    np.savez(os.path.join(tmp, name), **arrays)
    return name


def _write_manifest(d: str, manifest: Dict[str, Any]) -> None:
    """Write ``manifest.json`` via tmp-file + rename so a truncated
    manifest never carries the directory's name."""
    part = os.path.join(d, "manifest.json.part")
    with open(part, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, os.path.join(d, "manifest.json"))


def _publish(tmp: str, final: str) -> None:
    """Swap ``tmp`` into place.  Re-saving an existing step parks the old
    directory at ``<final>.old`` (invisible to ``all_steps``) until the
    new one is renamed in — at every crash point either the old or the
    new complete directory is restorable, never neither."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)


def _prune(base: str, keep: int) -> None:
    steps = sorted(all_steps(base))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def _manifest_ok(d: str) -> bool:
    """True iff the step dir has a parseable manifest whose shard files
    all exist — the restorability test ``all_steps`` applies."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        shards = m["shards"]
        m["step"], m["leaves"]
    except (OSError, ValueError, KeyError, TypeError):
        return False
    return all(os.path.exists(os.path.join(d, s)) for s in shards)


def all_steps(base: str) -> List[int]:
    """Restorable steps only: dirs with a missing or truncated manifest
    (a crash mid-save, a partial copy) are skipped, not surfaced."""
    if not os.path.isdir(base):
        return []
    out = []
    for d in os.listdir(base):
        m = _STEP_RE.match(d)
        if m and _manifest_ok(os.path.join(base, d)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(base: str) -> Optional[int]:
    steps = all_steps(base)
    return steps[-1] if steps else None


def _to_torch(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A stored array as a CPU tensor of its manifest dtype."""
    if dtype_name in _BITCAST_BY_NAME:
        dt, signed = _BITCAST_BY_NAME[dtype_name]
        return torch.from_numpy(arr.view(signed)).view(dt)
    return torch.from_numpy(arr)


def _read_shards(d: str, shards, dtypes) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for shard in shards:
        with np.load(os.path.join(d, shard)) as z:
            for k in z.files:
                name = k.replace("%", "/")
                out[name] = _to_torch(z[k], dtypes.get(name))
    return out


def _read_manifest(base: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(_step_dir(base, step), "manifest.json")) as f:
        return json.load(f)


def load_shard_group(
    base: str, step: int, group: int
) -> Dict[str, torch.Tensor]:
    """Load only device group ``group``'s leaves of step ``step``.

    The per-host read path of a sharded restore: each device group's host
    calls this with its own group id and never touches the other groups'
    shard files.  Returns ``{leaf_name: CPU tensor}`` (empty for groups
    beyond the save-time ``shard_groups``).
    """
    manifest = _read_manifest(base, step)
    shards = manifest.get("group_shards", {}).get(str(group))
    if shards is None:
        shards = manifest["shards"] if group == 0 else []
    dtypes = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    return _read_shards(_step_dir(base, step), shards, dtypes)


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    """``like``'s structure holding the named ``leaves``.  An ``nn.Module``
    comes back as ``{parameter name: tensor}`` (the caller loads it into a
    module); an ``OptState`` as an ``OptState`` with an int ``count``."""
    if isinstance(like, torch.nn.Module):
        return {n: leaves[f"{prefix}{n.replace('.', '/')}"]
                for n, _ in like.named_parameters()}
    if isinstance(like, OptState):
        def moments(d, key):
            return {k: leaves[f"{prefix}{key}/{k.replace('.', '/')}"]
                    for k in d}

        return OptState(mu=moments(like.mu, "mu"), nu=moments(like.nu, "nu"),
                        count=int(leaves[f"{prefix}count"]))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, leaves, f"{prefix}{i}/")
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    leaf = leaves[prefix[:-1] or "leaf"]
    return leaf.item() if isinstance(like, (bool, int, float)) else leaf


def restore_checkpoint(
    base: str, tree_like, step: Optional[int] = None
) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``tree_like``.  Returns (tree,
    manifest): every leaf a CPU tensor of the dtype its manifest names
    (placing it on a device is :func:`repro_torch.ckpt.restore_to_mesh`'s
    job)."""
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base}")
    manifest = _read_manifest(base, step)
    dtypes = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    loaded = _read_shards(_step_dir(base, step), manifest["shards"], dtypes)

    for name, like in _flatten_with_names(tree_like):
        if name not in loaded:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        want = tuple(like.shape) if hasattr(like, "shape") else None
        if want is not None and tuple(loaded[name].shape) != want:
            raise ValueError(
                f"leaf {name!r}: checkpoint shape "
                f"{tuple(loaded[name].shape)} != expected {want}"
            )
    return _rebuild(tree_like, loaded), manifest


class CheckpointManager:
    """Training-loop wrapper: periodic save, auto-resume, keep-k."""

    def __init__(self, base: str, *, every: int = 50, keep: int = 3,
                 shard_groups: int = 0):
        self.base = base
        self.every = every
        self.keep = keep
        self.shard_groups = shard_groups

    def maybe_save(self, step: int, tree, extra=None) -> Optional[str]:
        if self.every > 0 and step % self.every == 0:
            return self.save(step, tree, extra=extra)
        return None

    def save(self, step: int, tree, extra=None) -> str:
        """Unconditional snapshot (the elastic-restore path saves at the
        eviction step regardless of the periodic schedule)."""
        return save_checkpoint(
            self.base, step, tree, extra=extra, keep=self.keep,
            shard_groups=self.shard_groups,
        )

    def wait(self, *, raise_errors: bool = True) -> None:
        """Synchronous saves are durable on return; nothing to drain (the
        signature is :class:`AsyncCheckpointManager`'s)."""

    def restore_latest(self, tree_like):
        step = latest_step(self.base)
        if step is None:
            return None, None
        return restore_checkpoint(self.base, tree_like, step)
