"""The port's transformer against the JAX one on bridged params.

Reduced qwen3 (``reduced(get_arch("qwen3-0.6b"))``: 2 layers, d 64, GQA
4:2, qk-norm, tied embeddings) and the reduced MoE archs (qwen2-moe: MHA,
8 experts top-2 and a shared expert, untied head; qwen3-moe: GQA 4:1,
qk-norm, no shared expert) in fp32.  Params are initialized once in JAX
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
    ct, _ = model.init_paged_cache(B, cache_len, n_pages=n_pages,
                                   page_size=PS, cache_dtype=torch.float32)
    write_pages(ct, pt, rows)
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
