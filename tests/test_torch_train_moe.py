"""MoE training on the port against the JAX package, on the CPU.

The same numpy params (initialized once in JAX, handed over through
``repro_torch.bridge``) and the same batches go through both packages:

* the grouped matmul's autograd function in a float64 ``gradcheck``, with
  every group full and with ragged group sizes (an empty group, a full
  one), its input gradient zero on the rows past each group;
* reduced qwen2-moe and qwen3-moe: the loss, the router's aux loss and
  every gradient leaf of ``Transformer.loss`` (block remat) against JAX's
  ``model.loss`` under ``jax.value_and_grad`` (jitted), with kernels off
  (the einsum expert products) and on (the grouped matmul's function,
  whose CPU forward and dx are the plain version): 1e-5 each, as
  ``tests/test_torch_train.py`` holds the dense model; every gradient
  finite and at least 70 % of the leaves non-zero
  (``tests/test_arch_smoke.py:14``);
* the grouped matmul's launches under remat (three products forward,
  three in the recompute, three dx), the dead padded experts' zero
  gradients, three ``train_step``s against JAX's step function, and
  ``train`` on the MoE arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import train, train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 1e-5
MOE_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
S = 64


# ------------------------------------------------------- the grouped matmul


@pytest.mark.parametrize("sizes", [None, (0, 5, 2, 3)])
def test_grouped_matmul_gradcheck(sizes):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(4, 3, 6, dtype=torch.float64, generator=g,
                    requires_grad=True)
    gs = None if sizes is None else torch.tensor(sizes, dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x, w: ops.grouped_matmul(x, w, gs), (x, w))
    dx, = torch.autograd.grad(ops.grouped_matmul(x, w, gs).sum(), x)
    if gs is not None:
        dead = torch.arange(5)[None, :] >= gs[:, None]
        assert not bool(dx[dead].ne(0).any())
        assert bool(dx[~dead].ne(0).all())


# ------------------------------------------------------------- loss, grads


@pytest.fixture(scope="module", params=MOE_ARCHS)
def jax_moe(request):
    """JAX's reduced ``arch``: params, a batch, and the jitted loss, aux
    loss and gradients on it."""
    cfg = jax_reduced(jax_get_arch(request.param))
    model = jax_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, batch), has_aux=True))(params)
    return dict(arch=request.param, cfg=cfg, params=params,
                np_params=jax.tree.map(np.asarray, params), batch=batch,
                loss=float(loss), aux=float(parts["aux"]),
                grads=bridge.from_jax(jax.tree.map(np.asarray, grads), cfg))


def _port(arch, np_params, **sh):
    m = build_model(reduced(get_arch(arch)), ShardingConfig(**sh),
                    device="cpu", train=True)
    return bridge.load_jax_params(m, np_params)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_loss_aux_and_grads_match_jax(jax_moe, use_kernels):
    j = jax_moe
    m = _port(j["arch"], j["np_params"], use_kernels=use_kernels)
    loss, parts = m.loss({k: torch.from_numpy(v).long()
                          for k, v in j["batch"].items()})
    assert abs(float(loss.detach()) - j["loss"]) < ATOL
    aux = float(parts["aux"].detach())
    assert aux > 0.0 and abs(aux - j["aux"]) < ATOL
    named = list(m.impl.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert sorted(j["grads"]) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert bool(torch.isfinite(g).all()), name
        assert float(np.max(np.abs(g.numpy() - j["grads"][name]))) < ATOL, name
    nonzero = sum(bool(g.ne(0).any()) for g in grads)
    assert nonzero >= 0.7 * len(grads)
    assert all(bool(g.ne(0).any()) for (n, _), g in zip(named, grads)
               if n.endswith("router"))


@pytest.mark.parametrize("remat,per_layer", [("block", 9), ("none", 6)])
def test_grouped_matmul_runs_forward_recompute_and_dx(monkeypatch, remat,
                                                      per_layer):
    """With kernels on, each MoE layer's three expert products run forward,
    again in the block-remat recompute, and once more as dx in backward
    (dw is a ``torch.bmm``): on the CPU each run is the plain version, so
    the count of its calls is the card's launch count."""
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    calls = []
    real = ref.grouped_matmul_ref

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ref, "grouped_matmul_ref", counting)
    m = build_model(cfg, ShardingConfig(use_kernels=True, remat=remat),
                    device="cpu", train=True).init(0)
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    loss, _ = m.loss({"tokens": toks, "labels": toks.roll(-1, 1)})
    loss.backward()
    assert len(calls) == per_layer * cfg.n_layers


def test_dead_padded_experts_get_zero_gradient():
    """Padded (dead) experts are never routed: their expert stacks get an
    exactly zero gradient, as in JAX, while the router's is non-zero."""
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_to=12))
    for use_kernels in (False, True):
        m = build_model(cfg, ShardingConfig(use_kernels=use_kernels),
                        device="cpu", train=True).init(1)
        toks = torch.randint(0, cfg.vocab, (2, 32),
                             generator=torch.Generator().manual_seed(1))
        loss, _ = m.loss({"tokens": toks, "labels": toks.roll(-1, 1)})
        named = dict(m.impl.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        for name, g in grads.items():
            if name.rsplit(".", 1)[-1] in ("we_gate", "we_up", "we_down"):
                assert tuple(g.shape)[0] == 12
                assert not bool(g[8:].ne(0).any()), name
                assert bool(g[:8].ne(0).any()), name
            if name.endswith("router"):
                assert bool(g.ne(0).any()) and g.dtype == torch.float32


# ------------------------------------------------------------- train steps


@pytest.mark.parametrize("jax_moe", ["qwen2-moe-a2.7b"], indirect=True)
def test_three_moe_train_steps_match_jax_step_function(jax_moe):
    """``tests/test_torch_train.py``'s three-step check on reduced
    qwen2-moe: loss (nll + weighted aux), backward and AdamW without
    weight decay from bridged params, against JAX's jitted step function.
    Each loss within 1e-5; the params after three steps within 0.1·lr,
    99.9 % of them within 1e-3·lr.  Adam moves an entry whose gradient is
    near zero by up to lr, whatever the gradient's size: on reduced
    qwen3-moe one ``tok_embed`` entry has a gradient of 5e-7 with opposite
    signs in the two packages at the second step (fp32 noise: the leaf's
    gradients differ by at most 3.9e-6 against a largest entry of 0.71),
    the two updates put it 0.39·lr apart, and the third losses differ by
    5.3e-5, while the port's loss on JAX's params at that step is within
    1.4e-6 of JAX's."""
    j = jax_moe
    cfg, lr = j["cfg"], 3e-3
    kw = dict(peak_lr=lr, warmup_steps=1, total_steps=3)
    jopt = JaxAdamW(lr=lambda c: jax_warmup_cosine(c, **kw), weight_decay=0.0)
    opt = AdamW(lr=lambda c: warmup_cosine(c, **kw), weight_decay=0.0)
    jmodel = jax_build_model(cfg)

    @jax.jit
    def step_fn(params, opt_state, b):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, b), has_aux=True)(params)
        new_params, new_state = jopt.update(grads, opt_state, params)
        return new_params, new_state, loss

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=48,
                                  global_batch=4, seed=2))
    m = _port(j["arch"], j["np_params"], use_kernels=True)
    tparams = dict(m.impl.named_parameters())
    tstate = opt.init(tparams)
    jp, js = j["params"], jopt.init(j["params"])
    for step in range(3):
        b = data.batch(step)
        jp, js, jl = step_fn(jp, js, {k: jnp.asarray(v.numpy())
                                      for k, v in b.items()})
        tstate, tl = train_step(m, opt, tparams, tstate, b)
        assert abs(float(tl) - float(jl)) < ATOL, step
    want = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg)
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[name]).ravel()
                            for name, p in tparams.items()])
    assert float(diffs.max()) <= 0.1 * lr
    assert float(np.quantile(diffs, 0.999)) <= 1e-3 * lr


def test_train_runs_the_moe_arch_on_the_cpu():
    out = train("qwen2-moe-a2.7b", reduced_cfg=True, steps=3, batch=2, seq=64,
                verbose=False, device="cpu")
    assert len(out["history"]) == 3
    assert all(np.isfinite(x) for x in out["history"])
