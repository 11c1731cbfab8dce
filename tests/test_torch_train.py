"""The port's training path against the JAX package, on the CPU.

The same numpy inputs go through both packages:

* the flash autograd function (the kernel's forward, the plain version's
  recomputed gradient; on a CPU tensor the forward is the plain version
  too) against autograd of the plain version (exact: the same
  arithmetic) and against JAX's ``custom_vjp`` in interpret mode (1e-4,
  ``tests/test_kernels.py:218``);
* reduced qwen3's loss and every gradient leaf, the port with kernels on
  against JAX ``use_pallas=True`` at S 320 (1e-4 on h and the loss, 1e-5
  per leaf, ``tests/test_kernels.py:196``), with block remat in both;
* ``chunked_xent`` against the direct loss and with a mask (1e-4,
  ``tests/test_loss_properties.py:23,50``);
* AdamW and ``warmup_cosine`` against JAX's on the same trees (1e-6);
* three train steps (loss, backward, AdamW) against JAX's step function
  on bridged params and the same batches (1e-5 on each loss; the params
  after three steps within 0.1·lr, 99.9 % of them within 1e-3·lr: Adam
  turns a near-zero gradient into a step of up to lr);
* ``train()`` learns on the CPU (``tests/test_train_serve_drivers.py:10``);
* the data stream's and the straggler detector's properties
  (``tests/test_optim_data_ckpt.py:113,122,139,203,213``,
  ``tests/test_straggler_topology.py:110-136``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # optional extra: skip, never collection-error
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.kernels import ops as jax_ops
from repro.models import build_model as jax_build_model
from repro.models.transformer import chunked_xent as jax_chunked_xent
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch import bridge
from repro_torch.ckpt.straggler import StragglerDetector, TimingCollector
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.data import (DataConfig, MultiTaskMixture, SyntheticLM,
                              TaskStream)
from repro_torch.kernels import ops, ref
from repro_torch.launch.events import StragglerEventSource
from repro_torch.launch.train import make_train_state, train, train_step
from repro_torch.models import build_model
from repro_torch.models.layers import cross_entropy
from repro_torch.models.transformer import chunked_xent
from repro_torch.optim import AdamW, warmup_cosine

from port_testing import one_torch_thread, unoptimized_jax  # noqa: E402, F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- flash grad


@pytest.mark.parametrize("H,K", [(2, 2), (4, 2)])
def test_flash_autograd_matches_plain_and_jax_custom_vjp(H, K):
    """Gradients through the port's flash autograd function (the plain
    backward, ``ref.flash_attention_backward_ref``, from the forward's
    saved output and log-sum-exp) equal autograd of the plain forward
    within 1e-5 of each gradient's largest entry (the two sum in other
    orders), and JAX's custom_vjp (its Pallas kernel in interpret mode,
    its oracle's recompute) within 1e-4."""
    B, S, hd = 1, 128, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)

    def grads(fn):
        ins = [_t(x).requires_grad_() for x in (q, k, v)]
        (fn(*ins) ** 2).sum().backward()
        return [t.grad for t in ins]

    got = grads(ops.flash_attention)
    want = grads(ref.flash_attention_ref)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())

    def loss_jax(q, k, v):
        return jnp.sum(jax_ops.flash_attention(q, k, v, block_q=64,
                                               block_k=64) ** 2)

    jg = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, jg):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) < 1e-4


def test_flash_forward_runs_again_under_remat():
    """Under block remat the flash forward runs twice per layer (forward and
    recompute) and its backward once: on the CPU each call is the plain
    version, so the count of its calls is the launch count of the card.
    The backward never calls the plain forward."""
    cfg = reduced(get_arch("qwen3-0.6b"))
    calls = []
    real, real_bwd = ref.flash_attention_ref, ref.flash_attention_backward_ref

    def counting(*a, **kw):
        calls.append("forward")
        return real(*a, **kw)

    def counting_bwd(*a, **kw):
        calls.append("backward")
        return real_bwd(*a, **kw)

    toks = torch.randint(0, cfg.vocab, (2, 320), generator=torch.Generator()
                         .manual_seed(0))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    for remat, per_layer in (("block", 2), ("none", 1)):
        m = build_model(cfg, ShardingConfig(use_kernels=True, remat=remat),
                        device="cpu", train=True)
        m.init(0)
        calls.clear()
        ref.flash_attention_ref = counting
        ref.flash_attention_backward_ref = counting_bwd
        try:
            loss, _ = m.loss(batch)
            loss.backward()
        finally:
            ref.flash_attention_ref = real
            ref.flash_attention_backward_ref = real_bwd
        assert calls.count("forward") == per_layer * cfg.n_layers, (
            remat, calls)
        assert calls.count("backward") == cfg.n_layers, (remat, calls)


# ------------------------------------------------------ model loss and grads


@pytest.fixture(scope="module")
def jax_qwen3():
    cfg = jax_reduced(jax_get_arch("qwen3-0.6b"))
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _train_model(np_params, **sh):
    m = build_model(reduced(get_arch("qwen3-0.6b")), ShardingConfig(**sh),
                    device="cpu", train=True)
    return bridge.load_jax_params(m, np_params)


def test_training_layout_holds_fp32_masters(jax_qwen3):
    cfg, _, np_params = jax_qwen3
    m = _train_model(np_params)
    named = dict(m.impl.named_parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in named.values())
    back = bridge.jax_params(m)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert np.array_equal(a, b)
    full = build_model(get_arch("qwen3-0.6b"), device="cpu", train=True)
    assert {p.dtype for p in full.parameters()} == {torch.float32}
    serving = build_model(get_arch("qwen3-0.6b"), device="cpu")
    assert serving.impl.tok_embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serving.parameters())


def test_kernel_path_loss_and_grads_match_jax_pallas(jax_qwen3):
    """``tests/test_kernels.py:196`` on the port: reduced qwen3 at S 320
    (> 256, so both take the flash path), loss and every gradient leaf."""
    cfg, params, np_params = jax_qwen3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 320)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 320)).astype(np.int32)
    m_jax = jax_build_model(cfg, JaxShardingConfig(use_pallas=True))
    h_jax, _, _ = m_jax.impl.forward(params, toks)
    (l_jax, _), g_jax = jax.value_and_grad(
        lambda p: m_jax.loss(p, {"tokens": toks, "labels": lab}),
        has_aux=True)(params)

    m = _train_model(np_params, use_kernels=True)
    tt, tl = _t(toks).long(), _t(lab).long()
    with torch.no_grad():
        h, _ = m.impl.forward(tt)
    assert float(np.max(np.abs(h.numpy() - np.asarray(h_jax)))) < 1e-4
    loss, aux = m.loss({"tokens": tt, "labels": tl})
    assert float(aux["aux"]) == 0.0
    assert abs(float(loss.detach()) - float(l_jax)) < 1e-4
    named = list(m.impl.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = bridge.from_jax(jax.tree.map(np.asarray, g_jax), cfg)
    assert sorted(want) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert float(np.max(np.abs(g.numpy() - want[name]))) < 1e-5, name


def test_remat_none_gives_the_block_remat_gradients(jax_qwen3):
    _, _, np_params = jax_qwen3
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                         .manual_seed(2))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = {}
    for remat in ("block", "none"):
        m = _train_model(np_params, remat=remat)
        loss, _ = m.loss(batch)
        out[remat] = torch.autograd.grad(loss, list(m.impl.parameters()))
    for a, b in zip(out["block"], out["none"]):
        assert float((a - b).abs().max()) < 1e-6


def test_unported_training_paths_raise_naming_item_3b(jax_qwen3):
    """The refusals this test pinned are gone: item 3b (MoE and hybrid
    training, ``remat="sqrt"``) is ported.  What still raises is a remat
    mode that exists in neither package; the MoE and hybrid losses are
    finite, the MoE's with a non-zero router aux loss (their parity with
    JAX is in ``test_torch_train_moe.py`` and
    ``test_torch_train_hybrid.py``)."""
    _, _, np_params = jax_qwen3
    toks = torch.zeros((1, 8), dtype=torch.long)
    m = _train_model(np_params, remat="full")
    with pytest.raises(ValueError, match="unknown remat"):
        m.loss({"tokens": toks, "labels": toks})
    for arch in ("qwen2-moe-a2.7b", "recurrentgemma-9b"):
        m = build_model(reduced(get_arch(arch)), device="cpu", train=True)
        m.init(0)
        loss, parts = m.loss({"tokens": toks, "labels": toks})
        assert bool(torch.isfinite(loss))
        aux = float(parts["aux"].detach())
        assert (aux > 0.0) == (arch == "qwen2-moe-a2.7b")


# --------------------------------------------------------------- the loss


@settings(max_examples=10, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(1, 40), d=st.sampled_from([8, 16]),
       V=st.sampled_from([11, 32]), chunk=st.sampled_from([4, 7, 16, 64]))
def test_chunked_xent_equals_direct_and_jax(B, S, d, V, chunk):
    """Chunked (any chunk size, ragged padding) ≡ direct full-logit xent ≡
    the JAX chunked_xent, within 1e-4."""
    rng = np.random.default_rng(B * 1000 + S)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    got = float(chunked_xent(_t(h), _t(w), _t(labels), chunk=chunk))
    want = float(cross_entropy(_t(h) @ _t(w), _t(labels)))
    ref_jax = float(jax_chunked_xent(h, w, labels.astype(np.int32),
                                     chunk=chunk))
    assert abs(got - want) < 1e-4 and abs(got - ref_jax) < 1e-4


def test_chunked_xent_mask_and_gradient():
    rng = np.random.default_rng(0)
    h = _t(rng.standard_normal((2, 10, 8)).astype(np.float32))
    w = _t(rng.standard_normal((8, 17)).astype(np.float32))
    labels = _t(rng.integers(0, 17, (2, 10)))
    mask = torch.zeros((2, 10))
    mask[:, :4] = 1.0
    got = chunked_xent(h, w, labels, mask=mask, chunk=3)
    want = cross_entropy((h @ w)[:, :4], labels[:, :4])
    assert abs(float(got) - float(want)) < 1e-4
    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    gh, gw = torch.autograd.grad(chunked_xent(hg, wg, labels, mask, chunk=3),
                                 (hg, wg))
    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    rh, rw = torch.autograd.grad(
        cross_entropy(hg @ wg, labels, mask), (hg, wg))
    assert float((gh - rh).abs().max()) < 1e-5
    assert float((gw - rw).abs().max()) < 1e-5
    assert float(gh[:, 4:].abs().max()) == 0.0  # masked positions


# ------------------------------------------------------ optimizer, schedule


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.ones(8) * 3.0}
    state = opt.init(params)
    for _ in range(100):
        state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_grad_clip():
    opt = AdamW(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    opt.update({"w": torch.full((4,), 1e6)}, state, params)
    # clipped update magnitude bounded by lr regardless of grad scale
    assert float(params["w"].abs().max()) <= 1.0 + 1e-6


def test_adamw_moment_dtype_policy():
    opt = AdamW(lr=0.1, moment_dtype=torch.bfloat16)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.bfloat16
    state = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)}, state,
                       params)
    assert params["w"].dtype == torch.bfloat16
    assert state.nu["w"].dtype == torch.bfloat16 and state.count == 1


def test_no_weight_decay_on_1d():
    opt = AdamW(lr=0.0, weight_decay=1.0, grad_clip=0.0)
    params = {"norm": torch.ones(4), "w": torch.ones(4, 4)}
    state = opt.init(params)
    opt.update({k: torch.zeros_like(v) for k, v in params.items()}, state,
               params)
    assert torch.equal(params["norm"], torch.ones(4))  # lr=0: no change


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (1e-3, 0.1)])
def test_adamw_matches_jax(clip, wd):
    """Three updates of the same params with the same gradients (a clip
    that binds, none, and a tight one), on 1-D and 2-D leaves, under the
    warmup-cosine schedule: equal to JAX's within 1e-6."""
    rng = np.random.default_rng(11)
    shapes = {"w": (6, 5), "scale": (5,), "e": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32) * 3
           for k, s in shapes.items()} for _ in range(3)]
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = JaxAdamW(lr=lambda c: jax_warmup_cosine(c, **kw),
                    grad_clip=clip, weight_decay=wd)
    opt = AdamW(lr=lambda c: warmup_cosine(c, **kw), grad_clip=clip,
                weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: _t(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for g in gs:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        ts = opt.update({k: _t(v) for k, v in g.items()}, ts, tp)
    for k in shapes:
        assert float(np.max(np.abs(tp[k].numpy() - np.asarray(jp[k])))) < 1e-6
        assert float(np.max(np.abs(ts.nu[k].numpy()
                                   - np.asarray(js.nu[k])))) < 1e-6
    assert ts.count == int(js.count) == 3


def test_warmup_cosine_matches_jax():
    lrs = [warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100)
           for s in range(100)]
    want = [float(jax_warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                                    total_steps=100)) for s in range(100)]
    assert np.max(np.abs(np.asarray(lrs) - np.asarray(want))) < 1e-6
    assert lrs[0] == 0.0 and lrs[5] == pytest.approx(0.5)
    assert max(lrs) == pytest.approx(1.0, abs=0.02) and lrs[-1] < 0.2


# ------------------------------------------------------------- train steps


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_three_train_steps_match_jax_step_function(jax_qwen3, wd):
    """Loss, backward and AdamW for three steps on the same batches, from
    bridged params: the port's ``train_step`` against JAX's step function
    (``repro/launch/train.py``'s jitted ``step_fn``).  Each loss within
    1e-5.  Adam moves an entry by up to ~lr per step whatever its
    gradient's size, so an entry whose gradient is near zero — its sign
    left to float32 summation order — can move by another fraction of lr:
    the params after three steps agree within 0.1·lr at most and 1e-3·lr
    in 99.9 % of entries (the spread measured on this model: 0.03·lr and
    7e-4·lr).  With weight decay the decoder layers' norm scales differ
    by design: JAX stacks them (G, d) over the layer groups, so its "no
    decay on 1-D leaves" rule decays them; the port's are 1-D per layer
    and not decayed (ROADMAP queue 3).  That difference then feeds every
    later step, so with decay the losses are held (1e-5) and the norm
    scales shown to differ by JAX's decay; the other params are held
    without decay."""
    cfg, params, np_params = jax_qwen3
    lr = 3e-3
    kw = dict(peak_lr=lr, warmup_steps=1, total_steps=3)
    jopt = JaxAdamW(lr=lambda c: jax_warmup_cosine(c, **kw), weight_decay=wd)
    opt = AdamW(lr=lambda c: warmup_cosine(c, **kw), weight_decay=wd)
    jmodel = jax_build_model(cfg)

    @jax.jit
    def step_fn(params, opt_state, b):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, b), has_aux=True)(params)
        new_params, new_state = jopt.update(grads, opt_state, params)
        return new_params, new_state, loss

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=48,
                                  global_batch=4, seed=2))
    m = _train_model(np_params)
    tparams = dict(m.impl.named_parameters())
    tstate = opt.init(tparams)
    jp, js = params, jopt.init(params)
    for step in range(3):
        b = data.batch(step)
        jp, js, jl = step_fn(jp, js, {k: jnp.asarray(v.numpy())
                                      for k, v in b.items()})
        tstate, tl = train_step(m, opt, tparams, tstate, b)
        assert abs(float(tl) - float(jl)) < 1e-5, step
    want = bridge.from_jax(jax.tree.map(np.asarray, jp), cfg)
    stacked_norms = {n for n in tparams
                     if n.startswith("decoder.") and n.endswith(".scale")}
    if wd:
        for name in stacked_norms:  # JAX decayed them, at ~lr·wd per step
            d = tparams[name].detach().numpy() - want[name]
            assert float(d.min()) > 0.1 * lr * wd, name
        return
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[name]).ravel()
                            for name, p in tparams.items()])
    assert float(diffs.max()) <= 0.1 * lr
    assert float(np.quantile(diffs, 0.999)) <= 1e-3 * lr


def test_train_loss_decreases():
    out = train("qwen3-0.6b", reduced_cfg=True, steps=120, batch=16, seq=64,
                lr=3e-3, verbose=False, seed=0, device="cpu")
    first = sum(out["history"][:10]) / 10
    last = sum(out["history"][-10:]) / 10
    assert last < first - 0.04, f"no learning: {first:.3f} → {last:.3f}"
    assert len(out["step_seconds"]) == 120 and out["device"] == "cpu"


def test_train_resume_exact(tmp_path):
    """Checkpoint/restart reproduces the uninterrupted run
    (``tests/test_train_serve_drivers.py:18``, rel 1e-5): the interrupted
    run saves at steps 0 and 9 and not at its end, the resumed one restores
    into the model's own parameters and moments (and the step count) and
    saves at 18 and, off the cadence, at 19."""
    from repro_torch.ckpt import all_steps

    ck = str(tmp_path / "ck")
    kw = dict(reduced_cfg=True, steps=20, batch=4, seq=32, verbose=False,
              seed=1, device="cpu")
    full = train("xlstm-125m", **kw)
    cut = train("xlstm-125m", ckpt_dir=ck, ckpt_every=9, stop_at_step=10,
                **kw)
    assert len(cut["history"]) == 10 and all_steps(ck) == [0, 9]
    resumed = train("xlstm-125m", ckpt_dir=ck, ckpt_every=9, **kw)
    assert resumed["resumed_from"] == 9 and len(resumed["history"]) == 10
    assert resumed["history"][-1] == pytest.approx(full["history"][-1],
                                                   rel=1e-5)
    assert resumed["history"] == pytest.approx(full["history"][10:],
                                               rel=1e-5)
    assert resumed["opt_state"].count == full["opt_state"].count == 20
    assert max(float((resumed["params"][k] - p).detach().abs().max())
               for k, p in full["params"].items()) <= 1e-6
    assert all_steps(ck) == [9, 18, 19]  # keep 3


def test_crash_smoke_cli_recovers_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as train_mod

    monkeypatch.setattr("sys.argv", ["train", "--crash-smoke", "--device",
                                     "cpu", "--steps", "6", "--kill-at", "3"])
    train_mod.main()
    out = capsys.readouterr().out
    assert "[crash] OK: rollback_steps=3 restored_step=0" in out


def test_train_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train(steps=1, verbose=False)
    out = train(steps=2, batch=2, seq=8, verbose=False, device="cpu",
                plan_workload="qwen_val")
    assert out["mt_plan"] is not None and out["mt_plan"].steps


def test_make_train_state_is_seeded():
    cfg = reduced(get_arch("qwen3-0.6b"))
    opt = AdamW()
    a, sa = make_train_state(build_model(cfg, device="cpu", train=True),
                             opt, 4)
    b, _ = make_train_state(build_model(cfg, device="cpu", train=True),
                            opt, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(sa.mu) == set(a) and sa.count == 0


# ---------------------------------------------------------------------- data


def test_data_deterministic_and_restartable():
    d = SyntheticLM(DataConfig(vocab=512, seq_len=32, global_batch=4, seed=3))
    assert torch.equal(d.batch(7)["tokens"], d.batch(7)["tokens"])
    assert not torch.equal(d.batch(7)["tokens"], d.batch(8)["tokens"])
    b = d.batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < 512 and int(b["tokens"].min()) >= 0


def test_data_has_learnable_structure():
    """The Markov grammar must make the stream compressible (loss can drop)."""
    d = SyntheticLM(DataConfig(vocab=256, seq_len=64, global_batch=8, seed=0,
                               n_states=8))
    buckets = d.batch(0)["tokens"].numpy() // (256 // 8)
    trans = np.zeros((8, 8))
    for row in buckets:
        for a, c in zip(row[:-1], row[1:]):
            trans[a, c] += 1
    trans = trans / np.maximum(trans.sum(1, keepdims=True), 1)
    assert np.abs(trans - np.full((8, 8), 1 / 8)).max() > 0.15


def test_mixture_task_dynamics():
    def mk(seed):
        return SyntheticLM(DataConfig(vocab=128, seq_len=16, global_batch=2,
                                      seed=seed))

    mix = MultiTaskMixture([
        TaskStream("a", mk(0), 1.0, stubs={"img": ((3, 4), torch.float32)}),
        TaskStream("b", mk(1), 1.0)])
    b0 = mix.batch(0)
    assert set(b0) == {"a", "b"} and b0["a"]["img"].shape == (2, 3, 4)
    assert torch.equal(mix.batch(0)["a"]["img"], b0["a"]["img"])
    mix.set_weight("b", 0.0)  # task completion
    assert set(mix.batch(1)) == {"a"}


# ----------------------------------------------------------------- straggler


def test_straggler_detection_and_callback():
    hits = []
    sd = StragglerDetector(n_hosts=4, min_samples=4, threshold=1.5,
                           on_straggler=hits.append)
    for _ in range(6):
        sd.record_all([1.0, 1.0, 1.1, 3.0])
    assert sd.check() == [3]
    assert hits and hits[0] == [3]


def test_straggler_needs_samples():
    sd = StragglerDetector(n_hosts=2, min_samples=8)
    sd.record_all([1.0, 10.0])
    assert sd.stragglers() == []  # too few samples to judge


def test_detector_flags_only_with_min_samples_aggregated():
    det = StragglerDetector(n_hosts=4, min_samples=8, threshold=1.5)
    src = StragglerEventSource(
        det, collector=TimingCollector(n_hosts=4, skew={3: 3.0}))
    for _ in range(7):  # one short of min_samples: never flags
        src.record_step(1.0)
        assert det.stragglers() == [] and src.poll() == []
    src.record_step(1.0)  # 8th aggregated sample
    assert [e.hosts for e in src.poll()] == [(3,)]
    assert src.poll() == []  # debounced: same flagged set → no refire


def test_record_step_without_collector_cannot_flag():
    det = StragglerDetector(n_hosts=4, min_samples=4, threshold=1.5)
    src = StragglerEventSource(det)
    for _ in range(32):
        src.record_step(5.0)  # "slow", but there is nothing to compare to
    assert det.stragglers() == [] and src.poll() == []


def test_collector_skew_identity_and_recovery_event():
    assert TimingCollector(n_hosts=3).gather(2.0) == [2.0, 2.0, 2.0]
    det = StragglerDetector(n_hosts=4, window=4, min_samples=4)
    src = StragglerEventSource(det)
    for _ in range(4):
        for h, t in enumerate([1.0, 1.0, 1.1, 3.0]):
            src.record(h, t)
    assert [e.hosts for e in src.poll()] == [(3,)]
    for _ in range(4):
        det.record_all([1.0] * 4)
    assert [e.hosts for e in src.poll()] == [()]  # recovery fires once
