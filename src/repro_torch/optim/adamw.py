"""AdamW with a moment dtype policy, global-norm clipping and decoupled
weight decay (port of ``repro/optim/adamw.py``, the same arithmetic).

Parameters, gradients and moments are flat dicts of tensors keyed by
parameter name (``dict(module.named_parameters())``).  Moments are kept
in ``moment_dtype``; the update math runs in fp32 whatever the leaves'
dtypes, and the clip scale is applied inside each leaf's update (no fp32
copy of the whole gradient tree).  :meth:`AdamW.update` writes the new
parameters and moments into the given tensors, leaf by leaf, and returns
the new :class:`OptState` — JAX returns new trees instead; the values are
the same.  ``torch.optim.AdamW`` is not used: its arithmetic differs
(bias corrections folded into the step size, no clip).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Union

import torch


#: elements of a leaf :meth:`AdamW.update` handles at once
CHUNK = 1 << 24


@dataclass
class OptState:
    """Per-leaf first and second moments and the update count."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0

    def __repr__(self):
        return f"OptState(count={self.count})"


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖t‖²) in fp32, a 0-d tensor (no host sync)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4  # or schedule(count)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0  # global-norm clip; 0 disables
    moment_dtype: torch.dtype = torch.float32

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)

        return OptState(mu={k: zeros(p) for k, p in params.items()},
                        nu={k: zeros(p) for k, p in params.items()})

    def _lr(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor], *,
               gnorm: Optional[torch.Tensor] = None) -> OptState:
        """One step: ``params`` and the moments are updated in place;
        returns the state with the count advanced.  No weight decay on 1-D
        leaves (norms, gates).  ``gnorm`` is the gradients' global norm
        where they are shards of larger leaves (a rank's experts; see
        :func:`repro_torch.parallel.collectives.global_norm`); by default
        it is computed from ``grads``."""
        if set(grads) != set(params):
            raise KeyError(f"AdamW.update: grads for "
                           f"{sorted(set(grads) ^ set(params))} do not match "
                           f"the params")
        count = state.count + 1
        scale = None
        if self.grad_clip > 0:
            if gnorm is None:
                gnorm = global_norm(grads.values())
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        lr = self._lr(count)
        for name, p in params.items():
            decay = self.weight_decay if p.dim() > 1 else 0.0
            g_all = grads[name].reshape(-1)
            leaf = (p.view(-1), state.mu[name].view(-1),
                    state.nu[name].view(-1))
            # elementwise: a large leaf in slices of CHUNK elements, so its
            # fp32 temporaries stay that size (the same values)
            for lo in range(0, p.numel(), CHUNK):
                pc, m, v = (t[lo:lo + CHUNK] for t in leaf)
                g = g_all[lo:lo + CHUNK].float()
                if scale is not None:
                    g = g * scale
                m32 = m.float() * b1 + g * (1 - b1)
                v32 = v.float() * b2 + g.square() * (1 - b2)
                step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
                p32 = pc.float()
                pc.copy_(p32 - lr * (step + decay * p32))
                m.copy_(m32)
                v.copy_(v32)
        return OptState(mu=state.mu, nu=state.nu, count=count)
