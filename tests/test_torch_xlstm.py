"""The xLSTM cells and reduced xlstm-125m on the port against the JAX
package, on the CPU (fp32).

* ``mlstm_parallel`` at ``q_chunk`` S, 2, 3 and 8 (ragged last chunks,
  blocks above the diagonal skipped) against ``q_chunk=S`` and against
  JAX's at the same chunk, within 1e-4 (``tests/test_loss_properties.py
  :36``'s tolerance);
* ``mlstm_prefill_state`` (the closed form) and ``mlstm_decode`` after it,
  ``slstm_scan`` and ``slstm_decode`` against JAX's, within 1e-5;
* reduced xlstm: prefill logits and every cache leaf, then decode steps
  after the prefill, within 5e-4 (``tests/test_decode_equivalence.py``);
* the loss (1e-5) and every gradient leaf against jitted
  ``jax.value_and_grad`` of JAX's loss, each leaf within 1e-5 plus 1e-4 of
  its largest entry (fp32 sums in another order, amplified by the
  exponential gates: the tied embedding's gradient, largest entry 3.4,
  differs by 1.3e-4), three AdamW steps against JAX's step function
  (losses within 1e-5, params within Adam's lr-sized tolerance, no weight
  decay: JAX decays its stacked layer norms, ROADMAP queue 3), and
  ``train()`` on the arch.

The JAX functions run under ``jax.jit``: eager JAX compiles every op and
the sLSTM scan would cost seconds a call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import recurrent as jrec
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch import bridge
from repro_torch.config import get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import train, train_step
from repro_torch.models import build_model
from repro_torch.models import recurrent as trec
from repro_torch.optim import AdamW, warmup_cosine

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401

ARCH = "xlstm-125m"
B, S, H, HD, D = 2, 20, 4, 8, 32



def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < tol, err


# ----------------------------------------------------------------- the cells


@pytest.fixture(scope="module")
def cell_inputs():
    rng = np.random.default_rng(0)
    q, k, v = (_np(rng, (B, S, H, HD)) for _ in range(3))
    log_i = _np(rng, (B, S, H))
    log_f = np.log(1 / (1 + np.exp(-_np(rng, (B, S, H), 2.0)))).astype(
        np.float32)
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("q_chunk", [S, 2, 3, 8])
def test_mlstm_parallel_chunks_match_jax(cell_inputs, q_chunk):
    """The chunked parallel form is chunk-invariant and equals JAX's."""
    tq = [torch.from_numpy(a) for a in cell_inputs]
    got = trec.mlstm_parallel(*tq, q_chunk=q_chunk)
    full = trec.mlstm_parallel(*tq, q_chunk=S)
    want = jax.jit(jrec.mlstm_parallel, static_argnames=("q_chunk",))(
        *map(jnp.asarray, cell_inputs), q_chunk=q_chunk)
    assert got.shape == (B, S, H, HD) and bool(torch.isfinite(got).all())
    _close(got, full, 1e-4)
    _close(got, want, 1e-4)


def _mlstm_params(rng):
    dh = H * HD
    return {"wq": _np(rng, (D, dh), D ** -0.5),
            "wk": _np(rng, (D, dh), D ** -0.5),
            "wv": _np(rng, (D, dh), D ** -0.5),
            "w_if": _np(rng, (D, 2 * H), D ** -0.5),
            "wo": _np(rng, (dh, D), dh ** -0.5),
            "ogate": _np(rng, (D, dh), D ** -0.5)}


def test_mlstm_prefill_state_and_decode_match_jax():
    """The block's outputs and closed-form prefill state, then three decode
    steps from that state, against JAX's; the closed form also equals the
    state decode reaches by replaying the prompt token by token."""
    rng = np.random.default_rng(1)
    p = _mlstm_params(rng)
    x = _np(rng, (B, S + 3, D))
    kw = dict(n_heads=H, head_dim=HD)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _t(p)
    jy, jst = jax.jit(lambda p, x: jrec.mlstm_apply(
        p, x, return_state=True, **kw))(jp, jnp.asarray(x[:, :S]))
    ty, tst = trec.mlstm_apply(tp, torch.from_numpy(x[:, :S]),
                               return_state=True, **kw)
    _close(ty, jy, 1e-5)
    for key in ("C", "n", "m"):
        assert tst[key].dtype == torch.float32
        _close(tst[key], jst[key], 1e-5)
    jdec = jax.jit(lambda p, x, s: jrec.mlstm_decode(p, x, s, **kw))
    for t in range(S, S + 3):
        jy, jst = jdec(jp, jnp.asarray(x[:, t]), jst)
        ty, tst = trec.mlstm_decode(tp, torch.from_numpy(x[:, t]), tst, **kw)
        _close(ty, jy, 1e-5)
        for key in ("C", "n", "m"):
            _close(tst[key], jst[key], 1e-5)
    replay = trec.mlstm_state_init(B, H, HD)
    for t in range(S):
        _, replay = trec.mlstm_decode(tp, torch.from_numpy(x[:, t]), replay,
                                      **kw)
    _, closed = trec.mlstm_apply(tp, torch.from_numpy(x[:, :S]),
                                 return_state=True, **kw)
    # the stabiliser m may differ between the forms; C/e^{-m} may not
    for key in ("C", "n"):
        scale = torch.exp(closed["m"] - replay["m"])
        while scale.dim() < closed[key].dim():
            scale = scale[..., None]
        _close(closed[key] * scale, replay[key], 1e-4)


def test_slstm_scan_and_decode_match_jax():
    """The sequential scan over a prompt, then decode steps from its state,
    against JAX's; the fp32 states keep their dtype."""
    rng = np.random.default_rng(2)
    dh = H * HD
    p = {"w_in": _np(rng, (D, 4 * dh), D ** -0.5),
         "r": _np(rng, (4, H, HD, HD), HD ** -0.5),
         "wo": _np(rng, (dh, D), dh ** -0.5)}
    x = _np(rng, (B, S + 3, D))
    kw = dict(n_heads=H, head_dim=HD)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _t(p)
    jy, jst = jax.jit(lambda p, x: jrec.slstm_apply(p, x, **kw))(
        jp, jnp.asarray(x[:, :S]))
    ty, tst = trec.slstm_apply(tp, torch.from_numpy(x[:, :S]), **kw)
    _close(ty, jy, 1e-5)
    jdec = jax.jit(lambda p, x, s: jrec.slstm_decode(p, x, s, **kw))
    for t in range(S, S + 3):
        jy, jst = jdec(jp, jnp.asarray(x[:, t]), jst)
        ty, tst = trec.slstm_decode(tp, torch.from_numpy(x[:, t]), tst, **kw)
        _close(ty, jy, 1e-5)
        for key in ("c", "n", "h", "m"):
            assert tst[key].dtype == torch.float32
            _close(tst[key], jst[key], 1e-5)


# ----------------------------------------------------------- reduced xlstm


@pytest.fixture(scope="module")
def xlstm():
    """JAX's reduced model, its params and one jitted ``value_and_grad`` of
    its loss (the loss test and the train-step test share the compile: the
    sLSTM scan's gradient is the costly part)."""
    jmodel = jax_build_model(jax_reduced(jax_get_arch(ARCH)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0]))
    return jmodel, params, np_params, vg


#: the train-step shape: SyntheticLM batches of 2 x 32
DATA = DataConfig(vocab=256, seq_len=32, global_batch=2, seed=2)


def test_xlstm_prefill_and_decode_match_jax(xlstm):
    """Prefill logits and every (fp32) cache leaf of the 8-layer stack,
    then four decode steps at ragged per-row positions, within 5e-4."""
    jmodel, params, np_params, _ = xlstm
    model = bridge.load_jax_params(
        build_model(reduced(get_arch(ARCH)), device="cpu"), np_params)
    assert model.impl.decoder.kinds == ("mlstm",) * 3 + ("slstm",) + \
        ("mlstm",) * 3 + ("slstm",)
    assert not model.supports_chunked_prefill
    toks = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=(
        "cache_len", "cache_dtype"))(params, {"tokens": jnp.asarray(toks)},
                                     cache_len=48, cache_dtype=jnp.float32)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks).long()},
                           cache_len=48, cache_dtype=torch.float32)
    _close(tl, jl, 5e-4)
    want = bridge.from_jax(jax.tree.map(np.asarray, {"blocks": jc["groups"]}),
                           model.cfg)
    for name, arr in want.items():
        i, key = name.split(".")[2], name.split(".")[-1]
        _close(tc[int(i)][key], arr, 5e-4)
    dec = jax.jit(jmodel.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.asarray([40, 37], np.int32)  # positions only rotate attention
    for _ in range(4):
        jl, jc = dec(params, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = model.decode_step(torch.from_numpy(tok).long(), tc,
                                   torch.from_numpy(pos))
        _close(tl, jl, 5e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


def _port_train_model(np_params):
    m = build_model(reduced(get_arch(ARCH)), device="cpu", train=True)
    return bridge.load_jax_params(m, np_params)


def test_xlstm_loss_and_grads_match_jax(xlstm):
    """The loss under block remat and every gradient leaf against jitted
    ``jax.value_and_grad`` of JAX's loss (1e-5 + 1e-4 of the leaf's largest
    entry); every gradient finite and at least 70 % of the leaves
    non-zero."""
    jmodel, params, np_params, vg = xlstm
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, 256, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jloss, jgrads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = bridge.from_jax(jax.tree.map(np.asarray, jgrads), jmodel.cfg)
    m = _port_train_model(np_params)
    loss, parts = m.loss({k: torch.from_numpy(v).long()
                          for k, v in batch.items()})
    named = list(m.impl.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert float(parts["aux"]) == 0.0
    assert sorted(n for n, _ in named) == sorted(want)
    for (name, _), g in zip(named, grads):
        assert bool(torch.isfinite(g).all()), name
        _close(g, want[name], 1e-5 + 1e-4 * float(np.abs(want[name]).max()))
    assert sum(bool(g.ne(0).any()) for g in grads) >= 0.7 * len(grads)


def test_xlstm_train_steps_match_jax_step_function(xlstm):
    """Three AdamW steps under ``train()``'s schedule from bridged params
    against JAX's step function: each loss within 1e-5, the params after
    them within 0.5·lr and 1e-2·lr in 99.9 % of entries (measured: 0.15·lr
    and 1.5e-3·lr).  Adam moves an entry whose gradient is near zero by up
    to lr whatever its size, so a sign left to fp32 summation order puts
    that entry up to 2·lr apart; the exponential gates then amplify such
    a difference (at lr 3e-3 the third loss differs by 1e-3), so the
    steps run at lr 1e-4, where the losses agree to 1e-6."""
    jmodel, params, np_params, vg = xlstm
    lr = 1e-4
    kw = dict(peak_lr=lr, warmup_steps=1, total_steps=3)
    jopt = JaxAdamW(lr=lambda c: jax_warmup_cosine(c, **kw), weight_decay=0.0)
    opt = AdamW(lr=lambda c: warmup_cosine(c, **kw), weight_decay=0.0)
    update = jax.jit(jopt.update)
    data = SyntheticLM(DATA)
    m = _port_train_model(np_params)
    tparams = dict(m.impl.named_parameters())
    tstate = opt.init(tparams)
    jp, js = params, jopt.init(params)
    for step in range(3):
        b = data.batch(step)
        jl, grads = vg(jp, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        jp, js = update(grads, js, jp)
        tstate, tl = train_step(m, opt, tparams, tstate, b)
        assert abs(float(tl) - float(jl)) < 1e-5, step
    want = bridge.from_jax(jax.tree.map(np.asarray, jp), jmodel.cfg)
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[name]).ravel()
                            for name, p in tparams.items()])
    assert float(diffs.max()) <= 0.5 * lr
    assert float(np.quantile(diffs, 0.999)) <= 1e-2 * lr


def test_train_runs_the_ssm_arch_on_the_cpu():
    out = train(ARCH, reduced_cfg=True, steps=3, batch=2, seq=32,
                verbose=False, device="cpu")
    assert len(out["history"]) == 3 and out["device"] == "cpu"
    assert all(np.isfinite(x) for x in out["history"])
