"""The port's WaveEngine against the single-program reference and against
the JAX WaveEngine (the §3.6 numerical contract), on the CPU.

Params are initialized once in JAX and handed to both packages through
``repro_torch.bridge``; the batches are the port's numpy-seeded demo
batches, given to both.  Engine loss and every gradient leaf equal
autograd of ``MTModel.reference_loss`` and the JAX engine's within 1e-5
(``tests/test_engine.py``); on random MT graphs too
(``tests/test_engine_property.py``, at a small hypothesis budget).  Each
package plans its own copy of the planner (the port's defaults are the
H100's), so the plans may differ: the contract holds for any plan.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # optional extra: skip, never collection-error
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import plan as jax_plan
from repro.runtime import WaveEngine as JaxWaveEngine
from repro.runtime import tiny_multitask_clip as jax_tiny_clip
from repro.runtime import tiny_ofasys as jax_tiny_ofasys
from repro.runtime.mtmodel import ExecComponent as JaxExecComponent
from repro.runtime.mtmodel import ExecFlow as JaxExecFlow
from repro.runtime.mtmodel import MTModel as JaxMTModel
from repro_torch import bridge
from repro_torch.core import ClusterSpec, plan
from repro_torch.optim import AdamW
from repro_torch.runtime import (ExecComponent, ExecFlow, MTModel, WaveEngine,
                                 tiny_multitask_clip, tiny_ofasys)
from repro_torch.runtime.mtmodel import _demo_batches

from port_testing import one_torch_thread, unoptimized_jax  # noqa: E402, F401


TOL = 1e-5
MAKERS = {"clip": (tiny_multitask_clip, jax_tiny_clip),
          "ofasys": (tiny_ofasys, jax_tiny_ofasys)}


def _jax_batches(batches):
    return {t: {k: jnp.asarray(v.numpy()) for k, v in b.items()}
            for t, b in batches.items()}


def _reference(model, params, batches):
    loss, grads = model.reference_loss_and_grads(params, batches)
    return float(loss), grads


def _max_delta(grads, ref):
    assert set(grads) == set(ref)
    return max(float((grads[n] - ref[n]).abs().max()) for n in ref)


def _bridged(port_model, jax_model, seed=0):
    jparams = jax.jit(jax_model.init)(jax.random.PRNGKey(seed))
    params = bridge.load_mt_params(port_model.init(seed, device="cpu"),
                                   jax.tree.map(np.asarray, jparams))
    return params, jparams


@pytest.mark.parametrize("name", sorted(MAKERS))
@pytest.mark.parametrize("n_devices,island", [(4, 4), (8, 4), (16, 8)])
def test_engine_matches_reference(name, n_devices, island):
    model, batches = MAKERS[name][0]()
    params = model.init(0, device="cpu")
    ref_loss, ref_grads = _reference(model, params, batches)
    p = plan(model.graph, ClusterSpec(n_devices=n_devices, island_size=island))
    loss, grads = WaveEngine(model, p).loss_and_grads(params, batches)
    assert abs(float(loss) - ref_loss) < TOL
    assert _max_delta(grads, ref_grads) < TOL


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_engine_matches_jax_wave_engine(name):
    """The same params (bridged) and batches through both engines."""
    maker, jax_maker = MAKERS[name]
    model, batches = maker()
    jmodel, _ = jax_maker()
    params, jparams = _bridged(model, jmodel)
    cluster = dict(n_devices=8, island_size=4)
    jeng = JaxWaveEngine(jmodel, jax_plan(jmodel.graph,
                                          JaxClusterSpec(**cluster)))
    # jitted: the engine is a pure function of (params, batches) for a
    # fixed plan, and eager JAX compiles every op on first use
    jl, jg = jax.jit(jeng.loss_and_grads)(jparams, _jax_batches(batches))
    loss, grads = WaveEngine(
        model, plan(model.graph, ClusterSpec(**cluster))
    ).loss_and_grads(params, batches)
    assert abs(float(loss) - float(jl)) < TOL
    want = bridge.flatten_tree(jax.tree.map(np.asarray, jg))
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert float(np.max(np.abs(g.numpy() - want[n]))) < TOL, n
    # the instance names hold ":" — the ModuleDict and the bridge take them
    assert "img_text:contrastive" in params if name == "clip" else True
    back = bridge.mt_params_to_jax(dict(params.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))


def test_engine_shared_param_group_sync():
    """Shared components: engine grads = Σ task contributions."""
    model, batches = tiny_multitask_clip(n_tasks=3)
    params = model.init(1, device="cpu")
    eng = WaveEngine(model, plan(model.graph,
                                 ClusterSpec(n_devices=8, island_size=4)))
    groups = eng.param_device_groups()
    for comp in ("vision", "text", "audio"):
        assert comp in groups
    _, grads = eng.loss_and_grads(params, batches)
    assert any(bool((g != 0).any()) for n, g in grads.items()
               if n.startswith("text."))


def test_engine_train_step_descends():
    model, batches = tiny_ofasys()
    params = model.init(0, device="cpu")
    opt = AdamW(lr=1e-2, weight_decay=0.0)
    state = opt.init(dict(params.named_parameters()))
    eng = WaveEngine(model, plan(model.graph,
                                 ClusterSpec(n_devices=8, island_size=4)))
    losses = []
    for _ in range(8):
        params, state, loss = eng.train_step(params, state, batches, opt)
        losses.append(float(loss))
    assert losses[-1] < losses[0], f"no descent: {losses}"
    assert state.count == 8


def test_engine_backward_runs_in_reverse_wave_order():
    """One autograd.grad per recorded step, on the steps' outputs in the
    reverse of the forward order (the plan's waves): each step's graph is
    cut at its inputs, so no call reaches into another step's graph."""
    model, batches = tiny_multitask_clip()
    params = model.init(0, device="cpu")
    p = plan(model.graph, ClusterSpec(n_devices=8, island_size=4))
    eng = WaveEngine(model, p)
    forward, backward, waves = [], [], []
    real_step, real_grad = eng._forward_step, torch.autograd.grad

    def step(*a, **kw):
        rec = real_step(*a, **kw)
        forward.append(rec.out)
        return rec

    def grad(outputs, inputs, *a, **kw):
        backward.append(outputs)
        return real_grad(outputs, inputs, *a, **kw)

    eng._forward_step = step
    torch.autograd.grad = grad
    try:
        eng.loss_and_grads(params, batches,
                           on_wave=lambda w, steps: waves.append(len(steps)))
    finally:
        torch.autograd.grad = real_grad
    assert waves == [len(s) for _, s in sorted(p.waves().items())]
    assert len(forward) == sum(waves)
    assert [id(t) for t in backward] == [id(t) for t in reversed(forward)]


def test_engine_wave_structure_respects_plan():
    model, _ = tiny_multitask_clip()
    p = plan(model.graph, ClusterSpec(n_devices=8, island_size=4))
    WaveEngine(model, p)  # binding validates plan ↔ model consistency
    for steps in p.waves().values():
        devs = [d for s in steps for d in s.devices]
        assert len(devs) == len(set(devs))


def test_rebind_validates_before_mutating():
    """A failed rebind must leave the engine on its old (model, plan)."""
    model3, _ = tiny_multitask_clip(n_tasks=3)
    model2, _ = tiny_multitask_clip(n_tasks=2)
    cl = ClusterSpec(n_devices=8, island_size=4)
    eng = WaveEngine(model3, plan(model3.graph, cl))
    p3 = plan(model3.graph, cl)
    with pytest.raises(ValueError, match="rebind"):
        eng.rebind(p3, model=model2)  # p3 references ops model2 lacks
    assert eng.model is model3


def _random_models(seed: int):
    """``tests/test_engine_property.py``'s random MT graph, built in both
    packages from the same draws."""
    r = random.Random(seed)
    d = r.choice([16, 24, 32])
    towers = []
    for i in range(r.randint(2, 4)):
        towers.append((f"tow{i}", "tower", r.randint(1, 4),
                       d * r.choice([1, 2]), 4, r.random() < 0.7))
    mode = r.choice(["contrastive", "decoder", "merged_decoder"])
    batch = r.choice([2, 4])
    flows = []
    if mode == "contrastive":
        join = (("ctr", "contrastive", 1, d), {})
        pairs = [(a, b) for i, a in enumerate(towers) for b in towers[i + 1:]]
        r.shuffle(pairs)
        for t, (a, b) in enumerate(pairs[: r.randint(1, len(pairs))]):
            flows.append((f"task{t}", ((a[0],), (b[0],)), ("ctr",), batch,
                          {a[0]: r.randint(3, 8), b[0]: r.randint(3, 8)}))
    else:
        merged = mode == "merged_decoder"
        join = (("dec", "decoder", r.randint(1, 3), d, 4),
                dict(vocab=53, shared=True, merge_shared=merged))
        dec_seq = r.randint(4, 9)
        for t, tw in enumerate(towers):
            flows.append((f"task{t}", ((tw[0],),), ("dec",), batch,
                          {tw[0]: r.randint(3, 8),
                           "dec": dec_seq if merged else r.randint(4, 9)}))

    def build(comp_cls, flow_cls, model_cls):
        comps = [comp_cls(*t[:5], shared=t[5]) for t in towers]
        comps.append(comp_cls(*join[0], **join[1]))
        return model_cls(comps, [flow_cls(*f) for f in flows])

    return (build(ExecComponent, ExecFlow, MTModel),
            build(JaxExecComponent, JaxExecFlow, JaxMTModel))


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000), n_devices=st.sampled_from([4, 8, 16]))
def test_engine_matches_reference_on_random_graphs(seed, n_devices):
    model, jmodel = _random_models(seed)
    batches = _demo_batches(model, seed=seed)
    params, jparams = _bridged(model, jmodel, seed)
    p = plan(model.graph, ClusterSpec(n_devices=n_devices, island_size=4,
                                      mem_bytes=1e13))
    loss, grads = WaveEngine(model, p).loss_and_grads(params, batches)
    ref_loss, ref_grads = _reference(model, params, batches)
    assert abs(float(loss) - ref_loss) < TOL
    assert _max_delta(grads, ref_grads) < TOL
    jl, jg = jax.jit(jax.value_and_grad(jmodel.reference_loss))(
        jparams, _jax_batches(batches))
    assert abs(float(loss) - float(jl)) < TOL
    want = bridge.flatten_tree(jax.tree.map(np.asarray, jg))
    for n, g in grads.items():
        assert float(np.max(np.abs(g.numpy() - want[n]))) < TOL, n
