"""The port's MoE FFN against the JAX one, on the same numpy params and inputs.

``repro_torch.models.moe.moe_apply`` against ``repro.models.moe.moe_apply``
(local branch, no mesh) on reduced qwen2-moe and qwen3-moe in fp32, with
``use_kernels`` off (the JAX einsums) and on (the grouped-matmul entry
point, which computes its plain version for CPU tensors).  Tolerance
1e-5: both sides compute in fp32 and differ only in summation order; the
routing is discrete, so the cases use inputs whose top-k choices are not
near a tie.  Cases: a capacity factor small enough to drop assignments
(asserted), dead experts (``pad_to`` above ``n_experts``), and a shared
expert.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.config import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 1e-5
B, S = 2, 24

CASES = {
    # name: (arch, MoEConfig overrides)
    "overflow": ("qwen3-moe-30b-a3b", {"capacity_factor": 0.5}),
    "dead_experts": ("qwen3-moe-30b-a3b", {"pad_to": 12}),
    "shared": ("qwen2-moe-a2.7b", {}),
}


def _cfgs(case):
    arch, over = CASES[case]
    port = reduced(get_arch(arch))
    ref = jax_reduced(jax_get_arch(arch))
    port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, **over))
    ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **over))
    return port, ref


def _params(cfg, seed):
    """``moe_init``'s leaves from numpy: N(0, 1/d_in), dead experts zero."""
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    E, f = m.n_physical, m.d_ff_expert

    def normal(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def experts(d_in, d_out):
        w = np.zeros((E, d_in, d_out), np.float32)
        w[: m.n_experts] = normal((m.n_experts, d_in, d_out))
        return w

    p = {"router": normal((d, m.n_experts)), "we_gate": experts(d, f),
         "we_up": experts(d, f), "we_down": experts(f, d)}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared"] = {"w_gate": normal((d, fs)), "w_up": normal((d, fs)),
                       "w_down": normal((fs, d))}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, use_kernels):
    port_cfg, ref_cfg = _cfgs(case)
    params = _params(port_cfg, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (B, S, port_cfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_apply(_tree(params, jnp.asarray), jnp.asarray(x),
                                    ref_cfg)
    ops.reset_launch_counts()
    got, aux = tmoe.moe_apply(_tree(params, torch.from_numpy),
                              torch.from_numpy(x), port_cfg,
                              use_kernels=use_kernels)
    assert ops.launch_counts()["grouped_matmul"] == 0  # CPU: plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < ATOL
    assert abs(float(aux) - float(want_aux)) < ATOL

    # what the case is for; and no top-k choice near a tie (a rounding
    # difference could flip it)
    m = port_cfg.moe
    x2d = torch.from_numpy(x).reshape(-1, port_cfg.d_model)
    probs = torch.softmax(x2d @ torch.from_numpy(params["router"]), dim=-1)
    top = probs.topk(m.top_k + 1, dim=-1).values
    assert float((top[:, -2] - top[:, -1]).min()) > 1e-5
    _, idx, _ = tmoe.route(torch.from_numpy(params["router"]), x2d,
                           m.n_experts, m.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=m.n_physical)
    cap = tmoe.capacity(B * S, port_cfg)
    if case == "overflow":
        assert int((counts - cap).clamp_min(0).sum()) > 0, "no assignment dropped"
    if case == "dead_experts":
        assert m.n_physical > m.n_experts
        assert int(counts[m.n_experts:].sum()) == 0
    if case == "shared":
        assert m.n_shared_experts > 0


def test_capacity_is_the_jax_formula():
    """``max(int(T·k/E·cf), k)`` with the logical expert count (60)."""
    cfg = get_arch("qwen2-moe-a2.7b")
    assert tmoe.capacity(4096, cfg) == 341  # 8 × 512-token prefill
    assert tmoe.capacity(8, cfg) == 4  # an 8-slot decode step
    assert tmoe.capacity(1, cfg) == cfg.moe.top_k


def test_dropped_assignments_gather_in_range():
    """Every assignment overflows but one per expert: the combine reads
    the overflow bucket's index clamped into range (a torch index past
    the buffer would raise), and dropped assignments contribute zero."""
    T, d, f, E, k = 6, 8, 4, 2, 2
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((E, d, f), (E, f, d)))
    idx = torch.tensor([[0, 1]] * T)
    gates = torch.full((T, k), 0.5)
    for use_kernels in (False, True):
        out = tmoe.dispatch_compute_combine(x, gates, idx, w1, w1, w2, 1,
                                            use_kernels=use_kernels)
        h = x[0]
        want = sum(0.5 * ((torch.nn.functional.silu(h @ w1[e]) * (h @ w1[e]))
                          @ w2[e]) for e in range(E))
        assert torch.allclose(out[0], want, atol=ATOL)
        assert torch.equal(out[1:], torch.zeros_like(out[1:]))
