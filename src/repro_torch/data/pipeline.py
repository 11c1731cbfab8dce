"""Synthetic data pipeline: deterministic and restartable (port of
``repro/data/pipeline.py``), and :func:`shard_batch`, a rank's rows of a
global batch under a mesh.

Every batch is a pure function of ``(seed, step)``, so a run restarted at
step ``k`` sees the batches it would have seen.  Tokens follow a Markov
"grammar" over buckets of the vocabulary, so the LM loss can decrease.
JAX draws each batch with ``jax.random``, whose threefry bits PyTorch
cannot reproduce; this module walks the same chain (the same transition
matrix, drawn from numpy in both packages) with a numpy generator seeded
with ``(seed, step)``.  So the two packages' streams share their
properties, not their bits; parity tests feed one batch to both.

``MultiTaskMixture`` is the multi-task analogue: per-task streams, each
with its own modality stub shapes, sampled by weight; a weight of 0
removes a task (the workload shift that replans).  Stub seeds come from a
CRC of the task name: JAX's ``hash(name)`` is salted per process.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic "grammar": next-token depends on previous token bucket
    n_states: int = 32


class SyntheticLM:
    """Deterministic synthetic LM stream for one task."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed Markov transition over buckets; tokens ~ bucket * stride + noise
        self._trans = rng.dirichlet(
            np.ones(cfg.n_states) * 0.15, size=cfg.n_states
        ).astype(np.float32)
        self._cdf = np.cumsum(self._trans, axis=1)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch for ``step``: {tokens (B,S), labels (B,S)} int64 on the CPU
        (labels = the next token)."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, step])
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        n = cfg.n_states
        stride = max(V // n, 1)
        # Markov walk over buckets by inverse-CDF sampling
        u = rng.random((B, S + 1), dtype=np.float32)
        s = rng.integers(0, n, size=(B,))
        states = np.empty((B, S + 1), np.int64)
        for t in range(S + 1):
            s = (u[:, t, None] > self._cdf[s]).sum(axis=-1)
            states[:, t] = s
        noise = rng.integers(0, stride, size=(B, S + 1))
        toks = torch.from_numpy(np.clip(states * stride + noise, 0, V - 1))
        return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


@dataclass
class TaskStream:
    name: str
    data: SyntheticLM
    weight: float = 1.0
    # modality stubs added to each batch: name -> (shape-after-batch, dtype)
    stubs: Mapping[str, Tuple[Tuple[int, ...], Any]] = field(
        default_factory=dict)


class MultiTaskMixture:
    """Weighted multi-task batch mixture with time-varying proportions."""

    def __init__(self, tasks: Sequence[TaskStream], seed: int = 0):
        if not tasks:
            raise ValueError("need at least one task")
        self.tasks = list(tasks)
        self.seed = seed

    def weights_at(self, step: int) -> np.ndarray:
        w = np.asarray([t.weight for t in self.tasks], np.float64)
        return w / w.sum()

    def set_weight(self, name: str, weight: float) -> None:
        """Task addition/completion: weight 0 removes a task from the mix.

        Callers should re-run the Spindle planner after changing the mix
        (the paper's "plan regenerated when input workload changes")."""
        for t in self.tasks:
            if t.name == name:
                t.weight = weight
                return
        raise KeyError(name)

    def batch(self, step: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-task sub-batches for this step: {task: batch_dict}."""
        out = {}
        for t, wi in zip(self.tasks, self.weights_at(step)):
            if wi <= 0:
                continue
            b = dict(t.data.batch(step))
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(t.name.encode()), step])
            for sname, (shape, dtype) in t.stubs.items():
                B = b["tokens"].shape[0]
                x = rng.standard_normal((B,) + tuple(shape), np.float32)
                b[sname] = torch.from_numpy(x).to(dtype)
            out[t.name] = b
        return out


# ---------------------------------------------------------------------------
# Mesh placement
# ---------------------------------------------------------------------------


def shard_batch(batch, mesh, batch_axes: Sequence[str]):
    """This rank's rows of a global batch dict, its leading dim split over
    ``batch_axes`` in the order JAX's ``NamedSharding`` lays a tuple of
    axes (the first axis major: pod-major, then data).  Ranks that differ
    only along other axes (one model group) get the same rows.  A batch
    dim the axes' size does not divide stays whole, as ``batch_spec``
    leaves it."""
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    coord = tuple(mesh.get_coordinate())
    n, i = 1, 0
    for a in batch_axes:
        if a in names:
            k = names.index(a)
            n, i = n * shape[k], i * shape[k] + coord[k]

    def rows(x):
        B = x.shape[0]
        if n == 1 or B % n:
            return x
        return x[i * (B // n):(i + 1) * (B // n)]

    return {k: rows(v) for k, v in batch.items()}
