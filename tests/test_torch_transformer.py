"""The port's transformer against the JAX one on bridged params.

Reduced qwen3 (``reduced(get_arch("qwen3-0.6b"))``: 2 layers, d 64, GQA
4:2, qk-norm, tied embeddings), the reduced MoE archs (qwen2-moe: MHA,
8 experts top-2 and a shared expert, untied head; qwen3-moe: GQA 4:1,
qk-norm, no shared expert) and reduced recurrentgemma at 8 layers (two
remainder ``rglru`` layers, then two (rglru, rglru, local_attn) groups;
MQA, window 64) in fp32.  Params are initialized once in JAX
and handed to both packages through ``repro_torch.bridge``.  Prefill
logits and packed caches, then four paged decode steps, agree within
1e-4 (fp32 on both sides; the JAX side's chunked attention and XLA's
summation order differ from the port's by rounding only).
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
from repro.serving.batcher import _write_pages_impl
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving.batcher import write_pages

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 1e-4
PS = 8


@pytest.fixture(scope="module")
def jax_side():
    model = jax_build_model(jax_reduced(jax_get_arch("qwen3-0.6b")))
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def _port(np_params, use_kernels, arch="qwen3-0.6b"):
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, ShardingConfig(use_kernels=use_kernels),
                        device="cpu")
    return bridge.load_jax_params(model, np_params)


MOE_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_side(request):
    model = jax_build_model(jax_reduced(jax_get_arch(request.param)))
    params = model.init(jax.random.PRNGKey(1))
    return request.param, model, params, jax.tree.map(np.asarray, params)


def test_bridge_round_trip_is_exact(jax_side):
    _, _, np_params = jax_side
    back = bridge.jax_params(_port(np_params, False))
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S,use_kernels", [(20, False), (20, True),
                                           (300, False), (300, True)])
def test_prefill_logits_and_cache(jax_side, S, use_kernels):
    jmodel, params, np_params = jax_side
    _check_prefill(jmodel, params, _port(np_params, use_kernels), S)


@pytest.mark.parametrize("S,use_kernels", [(20, False), (20, True),
                                           (300, False), (300, True)])
def test_moe_prefill_logits_and_cache(moe_side, S, use_kernels):
    arch, jmodel, params, np_params = moe_side
    _check_prefill(jmodel, params, _port(np_params, use_kernels, arch), S)


def _check_prefill(jmodel, params, model, S):
    toks = _tokens(S, 2, S)
    cache_len = S + 8
    lj, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                            cache_len=cache_len, cache_dtype=jnp.float32)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks).long()},
                           cache_len=cache_len, cache_dtype=torch.float32)
    assert lt.dtype == torch.float32
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < ATOL
    for i, layer in enumerate(ct):
        for key in ("k", "v"):
            want = np.asarray(cj["groups"]["p0"][key][i])
            assert layer[key].shape == want.shape
            assert float(np.max(np.abs(layer[key].numpy() - want))) < ATOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_decode_steps(jax_side, use_kernels):
    """Prefill, map the caches into page pools through the same page
    tables, then four decode steps on the same tokens and positions."""
    jmodel, params, np_params = jax_side
    _check_decode(jmodel, params, _port(np_params, use_kernels))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_paged_decode_steps(moe_side, use_kernels):
    """The same on the MoE archs: every decode step routes the batch's
    rows through one capacity-bounded dispatch, as in JAX."""
    arch, jmodel, params, np_params = moe_side
    _check_decode(jmodel, params, _port(np_params, use_kernels, arch))


def test_bridge_carries_moe_leaves():
    """bf16 params with 4 dead experts over 3 layers (a layer-group axis
    of 3 beside an expert axis of 12): the router stays fp32, each layer
    gets its own (E, ...) expert stack with the dead experts zero, and the
    round trip back to the JAX layout is exact."""
    over = dict(n_layers=3, param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = jax_reduced(jax_get_arch("qwen2-moe-a2.7b"), **over)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, pad_to=12))
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(2)))
    cfg = reduced(get_arch("qwen2-moe-a2.7b"), **over)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_to=12))
    model = bridge.load_jax_params(build_model(cfg, device="cpu"), tree)
    stacked = tree["blocks"]["p0"]["ffn"]
    for i, layer in enumerate(model.impl.decoder.layers):
        ffn = layer.ffn
        assert ffn["router"].dtype == torch.float32
        assert ffn["we_gate"].dtype == torch.bfloat16
        assert tuple(ffn["we_up"].shape) == (12, 64, 64)
        np.testing.assert_array_equal(ffn["router"].numpy(), stacked["router"][i])
        np.testing.assert_array_equal(ffn["we_down"].float().numpy(),
                                      stacked["we_down"][i].astype(np.float32))
        assert not ffn["we_gate"][8:].any()
    back = bridge.jax_params(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        np.testing.assert_array_equal(got, leaf.astype(np.float32))


def _check_decode(jmodel, params, model):
    B, S, cache_len = 2, 11, 24
    n_pp = cache_len // PS
    n_pages = B * n_pp + 1
    toks = _tokens(9, B, S)
    rows = np.asarray([[4, 1, 6], [2, 5, 3]], np.int32)  # non-contiguous
    lj, pj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                            cache_len=cache_len, cache_dtype=jnp.float32)
    cj, layout = jmodel.init_paged_cache(B, cache_len, n_pages=n_pages,
                                         page_size=PS, cache_dtype=jnp.float32)
    cj = _write_pages_impl(cj, pj, jnp.arange(B), jnp.asarray(rows), layout)
    _, pt = model.prefill({"tokens": torch.from_numpy(toks).long()},
                          cache_len=cache_len, cache_dtype=torch.float32)
    ct, lt = model.init_paged_cache(B, cache_len, n_pages=n_pages,
                                    page_size=PS, cache_dtype=torch.float32)
    write_pages(ct, pt, np.arange(B), rows, lt)
    table = torch.from_numpy(rows)
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    for step in range(4):
        pos = np.full((B,), S + step, np.int32)
        lj, cj = jmodel.decode_step(params, jnp.asarray(tok), cj,
                                    jnp.asarray(pos), pages=jnp.asarray(rows))
        lt, ct = model.decode_step(torch.from_numpy(tok).long(), ct,
                                   torch.from_numpy(pos), pages=table)
        err = float(np.max(np.abs(lt.numpy() - np.asarray(lj))))
        assert err < ATOL, (step, err)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)


# ----------------------------------------------------------- recurrentgemma

RG_LAYERS = 8  # 2 remainder layers + 2 groups, as the full model's 2 + 12


@pytest.fixture(scope="module")
def rg_side():
    jcfg = jax_reduced(jax_get_arch("recurrentgemma-9b"), n_layers=RG_LAYERS)
    model = jax_build_model(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(3))
    # jitted once per shape: the eager JAX calls retrace the layer scans
    prefill = jax.jit(model.prefill, static_argnames=("cache_len",
                                                      "cache_dtype"))
    decode = jax.jit(model.decode_step)
    return (prefill, decode, model), params, jax.tree.map(np.asarray, params)


def _rg_port(np_params, use_kernels):
    cfg = reduced(get_arch("recurrentgemma-9b"), n_layers=RG_LAYERS)
    model = build_model(cfg, ShardingConfig(use_kernels=use_kernels),
                        device="cpu")
    return bridge.load_jax_params(model, np_params)


def _jax_layer(cache, i, n_rem=2, L=3):
    """Port layer ``i``'s state in a JAX cache (remainder layers, then
    group ``g``'s pattern slot ``j``)."""
    if i < n_rem:
        return cache["rem"][i]
    g, j = divmod(i - n_rem, L)
    return jax.tree.map(lambda x: x[g], cache["groups"][f"p{j}"])


def test_recurrentgemma_layer_kinds_follow_jax_order():
    model = build_model(
        reduced(get_arch("recurrentgemma-9b"), n_layers=RG_LAYERS),
        device="cpu")
    assert model.impl.decoder.kinds == (
        "rglru", "rglru", "rglru", "rglru", "local_attn",
        "rglru", "rglru", "local_attn")
    full = get_arch("recurrentgemma-9b")
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(full)
    assert kinds.count("rglru") == 26 and kinds.count("local_attn") == 12


@pytest.mark.parametrize("S,cache_len,use_kernels", [
    (20, 40, False),    # S < W = cache_len < window: zero-padded buffers
    (100, 120, True),   # S >= W = window: the last 64 rolled by S % 64
    (300, 320, True),   # S > 256: local_attention in the prefill
])
def test_recurrentgemma_prefill_logits_and_cache(rg_side, S, cache_len,
                                                 use_kernels):
    (prefill, _, _), params, np_params = rg_side
    model = _rg_port(np_params, use_kernels)
    toks = _tokens(S, 2, S)
    lj, cj = prefill(params, {"tokens": jnp.asarray(toks)},
                     cache_len=cache_len, cache_dtype=jnp.float32)
    lt, ct = model.prefill({"tokens": torch.from_numpy(toks).long()},
                           cache_len=cache_len, cache_dtype=torch.float32)
    assert float(np.max(np.abs(lt.numpy() - np.asarray(lj)))) < ATOL
    for i, layer in enumerate(ct):
        want = _jax_layer(cj, i)
        assert sorted(layer) == sorted(want)
        for key, got in layer.items():
            w = np.asarray(want[key])
            assert tuple(got.shape) == w.shape, (i, key)
            assert float(np.max(np.abs(got.numpy() - w))) < ATOL, (i, key)


@pytest.mark.parametrize("S,cache_len,use_kernels", [
    (20, 40, False), (60, 80, True), (100, 120, True)])
def test_recurrentgemma_decode_steps(rg_side, S, cache_len, use_kernels):
    """Prefill, map into the paged cache (slot-major state at slots 2 and 0
    of 3), then six decode steps on the same tokens and per-row positions:
    S = 60 crosses the window (64) while decoding, S = 100 starts past it,
    and S = 20 decodes into a buffer shorter than the window."""
    (prefill, decode, jmodel), params, np_params = rg_side
    model = _rg_port(np_params, use_kernels)
    B, slots = 2, np.asarray([2, 0])
    n_pp = -(-cache_len // PS)
    rows = (1 + np.arange(B * n_pp).reshape(B, n_pp)).astype(np.int32)
    toks = _tokens(S + 1, B, S)
    lj, pj = prefill(params, {"tokens": jnp.asarray(toks)},
                     cache_len=cache_len, cache_dtype=jnp.float32)
    cj, layout = jmodel.init_paged_cache(3, cache_len, n_pages=B * n_pp + 1,
                                         page_size=PS,
                                         cache_dtype=jnp.float32)
    cj = _write_pages_impl(cj, pj, jnp.asarray(slots), jnp.asarray(rows),
                           layout)
    _, pt = model.prefill({"tokens": torch.from_numpy(toks).long()},
                          cache_len=cache_len, cache_dtype=torch.float32)
    ct, lt = model.init_paged_cache(3, cache_len, n_pages=B * n_pp + 1,
                                    page_size=PS, cache_dtype=torch.float32)
    assert all(code == "state0" for layer in lt for code in layer.values())
    write_pages(ct, pt, slots, rows, lt)
    table = np.zeros((3, n_pp), np.int32)
    table[slots] = rows
    tok = np.zeros(3, np.int32)
    tok[slots] = np.asarray(jnp.argmax(lj, axis=-1))
    pos = np.asarray([S, 0, S], np.int32)  # row 1: a free slot
    for step in range(6):
        lj, cj = decode(params, jnp.asarray(tok), cj, jnp.asarray(pos),
                        pages=jnp.asarray(table))
        lt_, ct = model.decode_step(torch.from_numpy(tok).long(), ct,
                                    torch.from_numpy(pos),
                                    pages=torch.from_numpy(table))
        err = float(np.max(np.abs(lt_.numpy()[slots] - np.asarray(lj)[slots])))
        assert err < ATOL, (step, err)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        pos = pos + np.asarray([1, 0, 1], np.int32)


def _leaf_drawn(name):
    """A parameter drawn from N(0, std²), not set to ones."""
    return not name.endswith("scale")


def test_seeded_draw_in_blocks(monkeypatch):
    """A seeded draw fills each parameter block by block: a parameter of
    one block is one ``randn`` of its shape from the seed ``(seed << 20) +
    i``; the blocks of a larger one cover its live rows; drawn whole, in
    the pool (``draw_into``) or by ``init`` it is the same model, dead
    experts zero."""
    from repro_torch.launch.steps import draw_weights
    from repro_torch.models import transformer

    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    impl = build_model(cfg, device="cpu", train=True).impl
    named = list(impl.named_parameters())
    one = {n: impl.draw(7, i, n, p) for i, (n, p) in enumerate(named)}
    i, (name, p) = next((i, np_) for i, np_ in enumerate(named)
                        if np_[0].endswith("wq"))
    g = torch.Generator().manual_seed((7 << 20) + i)
    want = torch.randn(tuple(p.shape), generator=g) / np.sqrt(p.shape[0])
    assert torch.equal(one[name], want.to(p.dtype))

    monkeypatch.setattr(transformer, "DRAW_BLOCK", 1000)
    blocks = {n: impl.draw_blocks(n, p) for n, p in named}
    assert max(len(b) for b in blocks.values()) > 1
    for n, p in named:
        rows = [r for b in blocks[n] for r in range(b.start, b.stop)]
        live = cfg.moe.n_experts if p.dim() == 3 else p.shape[0]
        assert rows == list(range(live))
    whole = {n: impl.draw(7, i, n, p) for i, (n, p) in enumerate(named)}
    assert any(not torch.equal(whole[n], one[n]) for n in one)
    # every block its own values (the generator keeps a seed's low 32 bits)
    drawn = [impl.draw(7, i, n, p, k).flatten()[:8]
             for i, (n, p) in enumerate(named)
             if _leaf_drawn(n) for k in range(len(blocks[n]))]
    assert len({tuple(d.tolist()) for d in drawn}) == len(drawn)
    pooled = draw_weights(cfg, 7)
    impl.init(7)
    for n, p in named:
        assert torch.equal(pooled[n], whole[n]) and torch.equal(p, whole[n])
        if p.dim() == 3:
            assert not p[cfg.moe.n_experts:].any()
