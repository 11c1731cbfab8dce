"""The port's encoder-decoder (seamless-m4t family) against the JAX one.

Reduced seamless-m4t-medium (``reduced()``: 2 encoder + 2 decoder layers,
d 64, MHA 4 heads, hd 16) in fp32, params initialized once in JAX and
handed to both packages through ``repro_torch.bridge``.  The JAX model runs
no Pallas kernel (its ``attn_apply`` and ``attn_decode`` calls pass no
``impl``): ``chunked_attention`` past 256 tokens and the reference gather.
The port is held to it on its kernels-off path and on its kernel path,
whose flash and paged-decode wrappers compute their plain versions on the
CPU.  Tolerances are the reference's own: 1e-4 on logits and caches
(``tests/test_torch_transformer.py``), 1e-5 on gradients, and 5e-4 for
decode against the parallel forward (``tests/test_decode_equivalence.py``).
The JAX side is ``jax.jit``-ed: its eager layer scans retrace per call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serving.batcher import _write_pages_impl
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving.batcher import write_pages

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ARCH = "seamless-m4t-medium"
ATOL = 1e-4
GRAD_ATOL = 1e-5
PS = 8


def _jax_side(vocab=None):
    over = {} if vocab is None else {"vocab": vocab}
    model = jax_build_model(jax_reduced(jax_get_arch(ARCH), **over))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    impl = model.impl
    fns = dict(
        encode=jax.jit(impl.encode),
        prefill=jax.jit(model.prefill, static_argnames=("cache_len",
                                                         "cache_dtype")),
        decode=jax.jit(model.decode_step),
        loss=jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0])),
    )
    return model, params, jax.tree.map(np.asarray, params), fns


@pytest.fixture(scope="module")
def jax_side():
    return _jax_side()


def _port(np_params, use_kernels, *, train=False, vocab=None):
    over = {} if vocab is None else {"vocab": vocab}
    model = build_model(reduced(get_arch(ARCH), **over),
                        ShardingConfig(use_kernels=use_kernels),
                        device="cpu", train=train)
    return bridge.load_jax_params(model, np_params)


def _inputs(seed, B, S, E, d=64, vocab=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.standard_normal((B, E, d)).astype(np.float32))


def _err(got, want):
    return float(np.max(np.abs(got.detach().numpy() - np.asarray(want))))


def test_bridge_round_trip_is_exact(jax_side):
    _, _, np_params, _ = jax_side
    model = _port(np_params, False)
    assert len(model.impl.enc_blocks) == 2 and len(model.impl.dec_blocks) == 2
    back = bridge.jax_params(model)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("E,use_kernels", [(20, False), (300, False),
                                           (300, True)])
def test_encode_memory(jax_side, E, use_kernels):
    """The encoder's memory: naive attention at 20 frames, past 256 the
    chunked path (kernels off) or the flash kernel's plain version."""
    _, params, np_params, fns = jax_side
    _, frames = _inputs(E, 2, 1, E)
    want = fns["encode"](params, jnp.asarray(frames))
    got = _port(np_params, use_kernels).impl.encode(torch.from_numpy(frames))
    assert tuple(got.shape) == (2, E, 64)
    assert _err(got, want) < ATOL


@pytest.mark.parametrize("S,E,use_kernels", [(12, 20, False), (12, 20, True),
                                             (300, 280, False),
                                             (300, 280, True)])
def test_prefill_logits_and_every_cache_leaf(jax_side, S, E, use_kernels):
    """At S 300 every attention of the prefill takes the long path: the
    encoder over 280 frames, decoder self-attention, and cross-attention
    with Sq 300 against Sk 280."""
    _, params, np_params, fns = jax_side
    toks, frames = _inputs(S + E, 2, S, E)
    cache_len = S + 8
    lj, cj = fns["prefill"](params, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)},
                            cache_len=cache_len, cache_dtype=jnp.float32)
    model = _port(np_params, use_kernels)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks).long(),
                            "frames": torch.from_numpy(frames)},
                           cache_len=cache_len, cache_dtype=torch.float32)
    assert lt.dtype == torch.float32 and _err(lt, lj) < ATOL
    assert len(ct) == 2
    for i, layer in enumerate(ct):
        assert sorted(layer) == sorted(cj)
        for key, got in layer.items():
            want = np.asarray(cj[key][i])
            assert tuple(got.shape) == want.shape, (i, key)
            assert _err(got, want) < ATOL, (i, key)


def _paged_run(jax_side, model, S, E, steps, cache_dtype=jnp.float32):
    """Prefill two requests at slots 2 and 0 of 3, map both caches into
    page pools through the same non-contiguous tables, then ``steps``
    decode steps on the same tokens and per-row positions (row 1 a free
    slot).  Yields (step, port logits, JAX logits) of the live rows."""
    jmodel, params, _, fns = jax_side
    B, slots, cache_len = 2, np.asarray([2, 0]), S + steps + 4
    n_pp = -(-cache_len // PS)
    rows = (1 + np.arange(B * n_pp).reshape(B, n_pp)[:, ::-1]).astype(np.int32)
    toks, frames = _inputs(S * 7 + E, B, S, E)
    tdt = torch.float32 if cache_dtype == jnp.float32 else torch.bfloat16
    lj, pj = fns["prefill"](params, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)},
                            cache_len=cache_len, cache_dtype=cache_dtype)
    cj, layout = jmodel.init_paged_cache(3, cache_len, n_pages=B * n_pp + 1,
                                         page_size=PS, enc_len=E,
                                         cache_dtype=cache_dtype)
    cj = _write_pages_impl(cj, pj, jnp.asarray(slots), jnp.asarray(rows),
                           layout)
    lt, pt = model.prefill({"tokens": torch.from_numpy(toks).long(),
                            "frames": torch.from_numpy(frames)},
                           cache_len=cache_len, cache_dtype=tdt)
    yield -1, lt, np.asarray(lj)
    ct, lay = model.init_paged_cache(3, cache_len, n_pages=B * n_pp + 1,
                                     page_size=PS, enc_len=E,
                                     cache_dtype=tdt)
    assert [sorted(layer.values()) for layer in lay] == [
        ["kv0", "kv0", "state0", "state0"]] * 2
    write_pages(ct, pt, slots, rows, lay)
    table = np.zeros((3, n_pp), np.int32)
    table[slots] = rows
    tok = np.zeros(3, np.int32)
    tok[slots] = np.asarray(jnp.argmax(lj, axis=-1))
    pos = np.asarray([S, 0, S], np.int32)
    for step in range(steps):
        lj, cj = fns["decode"](params, jnp.asarray(tok), cj, jnp.asarray(pos),
                               pages=jnp.asarray(table))
        lt, ct = model.decode_step(torch.from_numpy(tok).long(), ct,
                                   torch.from_numpy(pos),
                                   pages=torch.from_numpy(table))
        yield step, lt[slots], np.asarray(lj)[slots]
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = pos + np.asarray([1, 0, 1], np.int32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_decode_steps(jax_side, use_kernels):
    """Every decode step's logits: self-attention through the page pools
    (the paged kernel's plain version with kernels on), cross-attention
    over the slot-major memory."""
    model = _port(jax_side[2], use_kernels)
    for step, got, want in _paged_run(jax_side, model, 11, 12, 5):
        assert _err(got, want) < ATOL, step


def test_bf16_cache_decode_matches_jax(jax_side):
    """A bf16 cache: the reference path rounds the attention weights to
    the cache dtype in self- and cross-attention decode, as JAX's does."""
    model = _port(jax_side[2], False)
    for step, got, want in _paged_run(jax_side, model, 11, 12, 4,
                                      cache_dtype=jnp.bfloat16):
        assert _err(got, want) < ATOL, step


def test_decode_matches_own_forward(jax_side):
    """``tests/test_decode_equivalence.py:70-86`` on the port: prefill 5
    tokens, then decode the rest; each step's logits equal the parallel
    decoder forward's at that position (< 5e-4)."""
    model = _port(jax_side[2], True)
    impl = model.impl
    B, T, E, P = 2, 10, 6, 5
    toks, frames = _inputs(4, B, T, E)
    tt, ff = torch.from_numpy(toks).long(), torch.from_numpy(frames)
    h, _ = impl.decode_forward(tt, impl.encode(ff))
    ref = (h @ impl.lm_head).float()
    lg, pc = model.prefill({"tokens": tt[:, :P], "frames": ff}, cache_len=T,
                           cache_dtype=torch.float32)
    assert float((lg - ref[:, P - 1]).abs().max()) < 5e-4
    n_pp = -(-T // PS)
    rows = (1 + np.arange(B * n_pp).reshape(B, n_pp)).astype(np.int32)
    cache, lay = model.init_paged_cache(B, T, n_pages=B * n_pp + 1,
                                        page_size=PS, enc_len=E,
                                        cache_dtype=torch.float32)
    write_pages(cache, pc, np.arange(B), rows, lay)
    for t in range(P, T):
        lg, cache = model.decode_step(tt[:, t], cache, t,
                                      pages=torch.from_numpy(rows))
        assert float((lg - ref[:, t]).abs().max()) < 5e-4, t


def test_slab_self_attention_decode_raises_naming_item_4b(jax_side):
    """Ported: the decoder's self-attention decodes through its slab
    beside the slot-major cross memory (``tests/test_serving.py:95``'s
    seamless leg).  Prefill into a slab, then decode steps at ragged
    per-row positions: logits (5e-4) and every cache leaf against JAX's
    slab decode."""
    _, params, np_params, fns = jax_side
    model = _port(np_params, False)
    B, P, T, E = 2, 6, 12, 4
    toks, frames = _inputs(9, B, P, E)
    jl, jc = fns["prefill"](params, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.asarray(frames)},
                            cache_len=T, cache_dtype=jnp.float32)
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks).long(),
                            "frames": torch.from_numpy(frames)},
                           cache_len=T, cache_dtype=torch.float32)
    pos = np.asarray([P, P - 2], np.int32)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = fns["decode"](params, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = model.decode_step(torch.from_numpy(tok).long(), tc,
                                   torch.from_numpy(pos))
        assert _err(tl, jl) < 5e-4
        pos = pos + 1
    for i, layer in enumerate(tc):
        for key, leaf in layer.items():
            assert _err(leaf, np.asarray(jc[key])[i]) < 5e-4, (i, key)


@pytest.mark.parametrize("vocab,S,use_kernels", [
    (None, 24, False),
    (None, 300, True),   # flash's plain-recompute gradient, Sq != Sk cross
    (259, 1030, False),  # an odd vocab (as 256,206) and chunked_xent's
])                       # ragged last chunk; chunked attention past 1,024
def test_loss_and_grads_match_jax(vocab, S, use_kernels, jax_side):
    """The training objective and every gradient leaf against JAX's
    ``jax.grad`` of its enc-dec loss."""
    _, params, np_params, fns = (jax_side if vocab is None
                                 else _jax_side(vocab))
    V = vocab or 256
    B, E = (2, 40) if S < 1024 else (1, 8)
    toks, frames = _inputs(S, B, S, E, vocab=V)
    labels = np.roll(toks, -1, axis=1)
    mask = (np.arange(S) < S - 3).astype(np.float32)[None].repeat(B, 0)
    batch = dict(tokens=toks, frames=frames, labels=labels, mask=mask)
    l_jax, g_jax = fns["loss"](params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    model = _port(np_params, use_kernels, train=True, vocab=vocab)
    named = list(model.impl.named_parameters())
    assert all(p.requires_grad and p.dtype == torch.float32 for _, p in named)
    loss, aux = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux["aux"]) == 0.0
    assert abs(float(loss.detach()) - float(l_jax)) < ATOL
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = bridge.from_jax(jax.tree.map(np.asarray, g_jax), model.cfg)
    assert sorted(want) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert _err(g, want[name]) < GRAD_ATOL, name
