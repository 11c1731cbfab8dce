"""Hybrid (recurrentgemma) training and ``remat="sqrt"`` on the port
against the JAX package, on the CPU.

* The RG-LRU scan's autograd function in a float64 ``gradcheck``, alone
  and with an initial state folded into its first input as
  ``rglru_apply`` folds it;
* reduced recurrentgemma at 5 layers — the full model's order: two
  remainder ``rglru`` layers, unchecked, then one (rglru, rglru,
  local_attn) group under block remat — the loss and every gradient leaf
  of ``Transformer.loss`` against JAX's ``model.loss`` under
  ``jax.value_and_grad`` (jitted: the eager JAX layer scans retrace on
  every call), with kernels off (the port's doubling scan) and on (the
  scan's function, whose CPU forward and reverse scan are the plain
  sequential version), within 1e-5 though the JAX model scans with
  ``associative_scan`` (the sums run in another order; at 8 layers the
  tied embedding's gradient, largest entry 2.3, differs by 1.6e-5);
  every gradient finite and at least 70 % of the leaves non-zero
  (``tests/test_arch_smoke.py:14``); S 64 is the reduced window, so no
  ragged q chunk (ROADMAP queue 3);
* the bridge on the bf16 training layout (fp32 ``lam``, the rest bf16);
* the scan's launches per layer (forward, remat recompute, reverse scan);
* ``remat="sqrt"`` on reduced qwen3 at 8 layers (8 groups: two outer
  segments of four) and at 7 (a prime count: block remat), equal to
  ``"none"`` and ``"block"`` within 1e-6 and to JAX's ``remat="sqrt"``
  gradients within 1e-5, each layer run up to three times (twice under
  block);
* ``train`` on the hybrid arch.
"""

import jax
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models import transformer as ttrans

ATOL = 1e-5
RG_LAYERS = 5
S = 64


# ------------------------------------------------------------------ the scan


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_gradcheck(with_h0):
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 9, 3, dtype=torch.float64, generator=g).requires_grad_()
    b = torch.randn(2, 9, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    h0 = torch.randn(2, 3, dtype=torch.float64, generator=g,
                     requires_grad=True)

    def scan(a, b, h0):
        if with_h0:  # rglru_apply's fold: h1 = a1·h0 + b1
            b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
        return ops.rglru_scan(a, b)

    assert torch.autograd.gradcheck(scan, (a, b, h0))


# ------------------------------------------------------------- loss, grads


def _jax_loss_and_grads(cfg, remat, batch):
    model = jax_build_model(cfg, JaxShardingConfig(remat=remat))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, batch), has_aux=True))(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            bridge.from_jax(jax.tree.map(np.asarray, grads), cfg))


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (2, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _port_loss_and_grads(arch, n_layers, np_params, batch, **sh):
    m = build_model(reduced(get_arch(arch), n_layers=n_layers),
                    ShardingConfig(**sh), device="cpu", train=True)
    bridge.load_jax_params(m, np_params)
    loss, parts = m.loss({k: torch.from_numpy(v).long()
                          for k, v in batch.items()})
    named = list(m.impl.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), parts, dict(zip((n for n, _ in named), grads))


@pytest.fixture(scope="module")
def jax_rg():
    cfg = jax_reduced(jax_get_arch("recurrentgemma-9b"), n_layers=RG_LAYERS)
    batch = _batch(cfg.vocab)
    return (batch, *_jax_loss_and_grads(cfg, "block", batch))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_loss_and_grads_match_jax(jax_rg, use_kernels):
    batch, np_params, want_loss, want = jax_rg
    loss, parts, grads = _port_loss_and_grads(
        "recurrentgemma-9b", RG_LAYERS, np_params, batch,
        use_kernels=use_kernels)
    assert abs(float(loss) - want_loss) < ATOL
    assert float(parts["aux"]) == 0.0
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        assert float(np.max(np.abs(g.numpy() - want[name]))) < ATOL, name
    assert sum(bool(g.ne(0).any()) for g in grads.values()) >= 0.7 * len(grads)


def test_bridge_carries_the_bf16_hybrid_training_layout():
    """The full config's dtypes (bf16 params): a training model takes the
    JAX leaves by name, holds ``lam`` in fp32 and the rest, ``w_r``/``w_i``
    included, in bf16, as JAX's params hold them (a serving model widens
    ``w_r``/``w_i`` to fp32 at load; a training model per call), and gives
    them back exactly."""
    over = dict(n_layers=RG_LAYERS, param_dtype="bfloat16",
                compute_dtype="bfloat16")
    jcfg = jax_reduced(jax_get_arch("recurrentgemma-9b"), **over)
    tree = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(jcfg).init)(jax.random.PRNGKey(4)))
    m = build_model(reduced(get_arch("recurrentgemma-9b"), **over),
                    device="cpu", train=True)
    bridge.load_jax_params(m, tree)
    for name, p in m.impl.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.float32 if leaf == "lam" else torch.bfloat16
        assert p.dtype == want and p.requires_grad, name
    back = dict(jax.tree_util.tree_leaves_with_path(bridge.jax_params(m)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        np.testing.assert_array_equal(back[path], leaf.astype(np.float32))


def test_scan_runs_forward_recompute_and_reverse(monkeypatch):
    """With kernels on, each rglru layer's scan runs forward and once more
    reversed in backward, and a layer inside a checkpointed group also in
    the recompute: 2 x 2 remainder layers + 3 x 2 group layers = 10, the
    card's launch count (phase 6f of ``chip_smoke.py``)."""
    cfg = reduced(get_arch("recurrentgemma-9b"), n_layers=RG_LAYERS)
    calls = []
    real = ref.rglru_scan_ref

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ref, "rglru_scan_ref", counting)
    m = build_model(cfg, ShardingConfig(use_kernels=True), device="cpu",
                    train=True).init(0)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    loss, _ = m.loss({"tokens": toks, "labels": toks.roll(-1, 1)})
    loss.backward()
    assert len(calls) == 10


# ------------------------------------------------------------- sqrt remat


@pytest.mark.parametrize("n_layers,runs", [(8, 22), (7, 14)])
def test_sqrt_remat_gives_the_same_gradients_as_jax(monkeypatch, n_layers,
                                                    runs):
    """8 groups: ``_sqrt_factor`` 2, two checkpointed segments of four
    checkpointed groups, each layer run three times (forward, the
    segment's recompute, the group's) but the last of each segment, run
    twice: torch's non-reentrant checkpoint stops a recompute once the
    tensors backward needs are back, and nothing in the segment keeps the
    last group's output.  7 groups (prime): block remat, each layer run
    twice."""
    cfg = jax_reduced(jax_get_arch("qwen3-0.6b"), n_layers=n_layers)
    batch = _batch(cfg.vocab, seed=2)
    np_params, want_loss, want = _jax_loss_and_grads(cfg, "sqrt", batch)
    calls = []
    real = ttrans._layer_apply

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttrans, "_layer_apply", counting)
    out = {}
    for remat in ("sqrt", "block", "none"):
        calls.clear()
        out[remat] = _port_loss_and_grads("qwen3-0.6b", n_layers, np_params,
                                          batch, remat=remat)
        out[remat] += (len(calls),)
    assert out["sqrt"][3] == runs
    assert out["block"][3] == 2 * n_layers
    assert out["none"][3] == n_layers
    loss, _, grads, _ = out["sqrt"]
    assert abs(float(loss) - want_loss) < ATOL
    for name, g in grads.items():
        assert float(np.max(np.abs(g.numpy() - want[name]))) < ATOL, name
        for other in ("block", "none"):
            assert float((g - out[other][2][name]).abs().max()) < 1e-6, name


def test_train_runs_the_hybrid_arch_on_the_cpu():
    out = train("recurrentgemma-9b", reduced_cfg=True, steps=3, batch=2,
                seq=64, verbose=False, device="cpu")
    assert len(out["history"]) == 3
    assert all(np.isfinite(x) for x in out["history"])
