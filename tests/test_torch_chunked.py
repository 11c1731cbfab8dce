"""Chunked prefill on the port against the JAX package.

Each test names its target in the JAX package.  The layers
(``attn_prefill_chunk``, ``Transformer.prefill_chunk``) are held within
1e-5 / 1e-4 on the same numpy inputs and bridged params (fp32 on both
sides); the serving session is held token for token and counter for
counter against the JAX ``ServingSession`` on the same trace (reduced
qwen3 and qwen2-moe, fp32 cache, on the CPU: the port's kernels run their
plain versions here).  MoE chunked serving is compared only where every
request is in one chunk job and no row decodes while another prefills:
a chunk's rows share expert capacity, and a stale row of the decode batch
reads the trash page, whose contents the port leaves unspecified.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import attention as jatt
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingSession as JaxServingSession
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.models import attention as tatt
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingConfig, ServingSession

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
D, H, KV, HD, THETA, PS = 64, 4, 2, 16, 1e6, 8
COUNTERS = ("chunk_steps", "interleaved_chunks", "decode_steps",
            "prefill_calls", "output_tokens", "kv_page_hw", "kv_defers",
            "kv_grow_allocs", "kv_grow_defers", "kv_preemptions")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sides(arch, seed):
    jmodel = jax_build_model(jax_reduced(jax_get_arch(arch)))
    params = jmodel.init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)

    def port(use_kernels=True):
        model = build_model(reduced(get_arch(arch)),
                            ShardingConfig(use_kernels=use_kernels),
                            device="cpu")
        return bridge.load_jax_params(model, np_params)

    return jmodel, params, port


@pytest.fixture(scope="module")
def qwen3():
    return _sides("qwen3-0.6b", 0)


@pytest.fixture(scope="module")
def moe():
    return _sides("qwen2-moe-a2.7b", 0)


def _run_pair(sides, specs, port_kw=None, **kw):
    """Serve ``specs`` ((rid, tokens, max_new, arrival[, family])) through
    the JAX session and the port's with the same config; returns (port
    session, port metrics, JAX session, JAX metrics)."""
    jmodel, params, port = sides
    port_kw = port_kw or {}
    kw.setdefault("replan", "off")
    kw.setdefault("cache_dtype", "float32")
    kw.setdefault("page_size", PS)
    jsess = JaxServingSession(JaxServingConfig(kv_layout="paged", **kw),
                              model=jmodel, params=params)
    m_jax = jsess.run([JaxRequest(rid=s[0], tokens=jnp.asarray(s[1]),
                                  max_new_tokens=s[2], arrival=s[3],
                                  family=(s[4] if len(s) > 4 else "default"))
                       for s in specs], max_steps=1000)
    sess = ServingSession(ServingConfig(device="cpu", **kw, **port_kw),
                          model=port())
    m = sess.run([Request(rid=s[0], tokens=s[1], max_new_tokens=s[2],
                          arrival=s[3],
                          family=(s[4] if len(s) > 4 else "default"))
                  for s in specs], max_steps=1000)
    return sess, m, jsess, m_jax


def _tokens(sess):
    return {r: sess.results[r].tokens for r in sorted(sess.results)}


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("pos0", [0, 8, 16])
def test_attn_prefill_chunk_matches_jax(pos0):
    """``attn_prefill_chunk`` (attention.py:424): 8-token chunks at 0, 8,
    ... up to ``pos0`` through a shuffled page table, qk-norm and RoPE;
    each chunk's output within 1e-5 of JAX's, and the pools' mapped pages
    equal after the last."""
    rng = np.random.default_rng(30 + pos0)
    B, C, n_pp = 2, 8, 4
    params = {"wq": _np(rng, (D, H * HD), D ** -0.5),
              "wk": _np(rng, (D, KV * HD), D ** -0.5),
              "wv": _np(rng, (D, KV * HD), D ** -0.5),
              "wo": _np(rng, (H * HD, D), (H * HD) ** -0.5)}
    P = B * n_pp + 1
    table = (1 + rng.permutation(B * n_pp)).reshape(B, n_pp).astype(np.int32)
    pool_k, pool_v = _np(rng, (P, KV, PS, HD)), _np(rng, (P, KV, PS, HD))
    jk, jv = jnp.asarray(pool_k), jnp.asarray(pool_v)
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA, qk_norm=True)
    for p0 in range(0, pos0 + 1, C):
        x = _np(rng, (B, C, D))
        yj, jk, jv = jatt.attn_prefill_chunk(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jk, jv, jnp.asarray(table), p0, **kw)
        yt, tk, tv = tatt.attn_prefill_chunk(
            {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(x), tk, tv, torch.from_numpy(table), p0, **kw)
        assert float(np.abs(yt.numpy() - np.asarray(yj)).max()) < 1e-5
    mapped = np.unique(table)
    for got, want in ((tk, jk), (tv, jv)):
        assert float(np.abs(got.numpy()[mapped]
                            - np.asarray(want)[mapped]).max()) < 1e-5


def _chunk_logits(model, toks, chunk, *, jax_params=None):
    """Run ``toks`` (B, S) through ``prefill_chunk`` in ``chunk``-token
    steps over a fresh paged fp32 cache; returns each step's logits."""
    B, S = toks.shape
    n_pp = -(-S // PS)
    table = (1 + np.arange(B * n_pp)[::-1]).reshape(B, n_pp).astype(np.int32)
    out = []
    if jax_params is not None:
        cache, _ = model.init_paged_cache(B, n_pp * PS, n_pages=B * n_pp + 1,
                                          page_size=PS,
                                          cache_dtype=jnp.float32)
        for p0 in range(0, S, chunk):
            logits, cache = model.prefill_chunk(
                jax_params, jnp.asarray(toks[:, p0:p0 + chunk]), cache, p0,
                pages=jnp.asarray(table))
            out.append(np.asarray(logits))
        return out
    cache, _ = model.init_paged_cache(B, n_pp * PS, n_pages=B * n_pp + 1,
                                      page_size=PS, cache_dtype=torch.float32)
    for p0 in range(0, S, chunk):
        logits, cache = model.prefill_chunk(
            torch.from_numpy(toks[:, p0:p0 + chunk]).long(), cache, p0,
            pages=torch.from_numpy(table))
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_transformer_prefill_chunk_logits_match_jax(qwen3, moe, arch,
                                                    use_kernels):
    """``Transformer.prefill_chunk`` (transformer.py:745): three 8-token
    chunks of two 20-token prompts (the last chunk ragged) give JAX's
    logits within 1e-4 after every chunk; for the dense model the last
    chunk's logits are the one-shot prefill's (an fp32 cache is lossless;
    an MoE chunk's expert capacity is the chunk's, not the prompt's)."""
    jmodel, params, port = qwen3 if arch == "qwen3-0.6b" else moe
    model = port(use_kernels)
    assert model.supports_chunked_prefill
    toks = np.random.default_rng(31).integers(0, 256, (2, 20)).astype(np.int32)
    got = _chunk_logits(model, toks, 8)
    want = _chunk_logits(jmodel, toks, 8, jax_params=params)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) < 1e-4
    if arch == "qwen3-0.6b":
        one_shot, _ = model.prefill(
            {"tokens": torch.from_numpy(toks).long()}, cache_len=24,
            cache_dtype=torch.float32)
        assert float(np.abs(got[-1] - one_shot.numpy()).max()) < 1e-4


def test_recurrentgemma_does_not_chunk():
    """Chunked prefill applies to all-attention stacks only; a hybrid model
    serves its prompts one-shot with ``prefill_chunk`` set, as in JAX."""
    model = build_model(reduced(get_arch("recurrentgemma-9b")),
                        device="cpu").init(0)
    assert not model.supports_chunked_prefill
    with pytest.raises(ValueError, match="all-attention"):
        model.impl.decoder.decode_chunk(torch.zeros(1, 4, 64), [], 0,
                                        pages=torch.zeros(1, 1))
    sess = ServingSession(ServingConfig(
        arch="recurrentgemma-9b", device="cpu", max_slots=2, cache_len=48,
        prefill_chunk=8, prefix_sharing=True, kv_admission="grow",
        replan="off"), model=model)
    assert sess.batcher.prefill_chunk == 0 and sess.batcher.index is None
    assert sess.batcher.kv_admission == "reserve"
    sess.run([Request(rid=0, tokens=np.arange(20), max_new_tokens=3)])
    m = sess.metrics()
    assert m["chunk_steps"] == 0 and m["prefill_calls"] == 1
    assert len(sess.results[0].tokens) == 3


# --------------------------------------------------------------- serving


def _chunk_specs():
    """tests/test_serving.py:126's trace: prompts of 37, 21 and 40 tokens
    arriving one step apart, 6 new tokens each."""
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 256, (p,)).astype(np.int32), 6, float(i))
            for i, p in enumerate((37, 21, 40))]


@pytest.mark.parametrize("use_kernels", [True, False])
def test_chunked_serving_equals_jax_and_one_shot(qwen3, use_kernels):
    """tests/test_serving.py:126: 16-token chunks in 2 slots give JAX's
    chunked tokens and the one-shot tokens, with JAX's chunk steps and
    interleaved chunks (both > 0: long prompts chunk, and chunks run
    between live decode steps)."""
    jmodel, params, port = qwen3
    sess, m, jsess, m_jax = _run_pair(
        (jmodel, params, lambda: port(use_kernels)), _chunk_specs(),
        max_slots=2, cache_len=64, prefill_chunk=16)
    one = ServingSession(ServingConfig(device="cpu", max_slots=2,
                                       cache_len=64, page_size=PS,
                                       cache_dtype="float32", replan="off"),
                         model=port(use_kernels))
    one.run([Request(rid=r, tokens=t, max_new_tokens=g, arrival=a)
             for r, t, g, a in _chunk_specs()])
    assert _tokens(sess) == _tokens(jsess) == _tokens(one)
    assert m["chunk_steps"] > 0 and m["interleaved_chunks"] > 0
    for key in COUNTERS:
        assert m[key] == m_jax[key], key
    assert one.metrics()["chunk_steps"] == 0


def test_prefill_duty_half_interleaves_as_jax(qwen3):
    """``prefill_duty=0.5`` (session.py:374): one chunk every other decode
    step — the chunk, interleave and decode counts and the tokens are
    JAX's, and the duty stretches the prefill over more decode steps than
    duty 1.0 does."""
    specs = _chunk_specs()
    sess, m, jsess, m_jax = _run_pair(qwen3, specs, max_slots=2,
                                      cache_len=64, prefill_chunk=8,
                                      prefill_duty=0.5)
    assert _tokens(sess) == _tokens(jsess)
    for key in COUNTERS:
        assert m[key] == m_jax[key], key
    full, m_full, _, _ = _run_pair(qwen3, specs, max_slots=2, cache_len=64,
                                   prefill_chunk=8)
    assert _tokens(full) == _tokens(sess)
    assert m["interleaved_chunks"] > 0
    assert m["decode_steps"] > m_full["decode_steps"]
    with pytest.raises(ValueError, match="prefill_duty"):
        ServingConfig(prefill_duty=0.0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_chunked_one_job_equals_jax(moe, use_kernels):
    """Reduced qwen2-moe, three 40-token prompts arriving together in
    three slots, 16-token chunks: one chunk job (3 chunks of 3 rows at the
    chunk's expert capacity), then every decode step with all rows live —
    JAX's tokens and counters."""
    jmodel, params, port = moe
    rng = np.random.default_rng(32)
    specs = [(i, rng.integers(0, 256, (40,)).astype(np.int32), 6, 0.0)
             for i in range(3)]
    sess, m, jsess, m_jax = _run_pair(
        (jmodel, params, lambda: port(use_kernels)), specs, max_slots=3,
        cache_len=48, prefill_chunk=16)
    assert _tokens(sess) == _tokens(jsess) and len(sess.results) == 3
    assert m["chunk_steps"] == 3 and m["prefill_calls"] == 1
    for key in COUNTERS:
        assert m[key] == m_jax[key], key


def test_serve_cli_prefix_smoke_exits_zero():
    """The CLI's ``--prefix-smoke`` (launch/serve.py:236) on the CPU: shared
    and unshared runs of one shared-prefix trace, token-exact, with hits
    and a lower page high-water."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--prefix-smoke", "--shared-prefix", "16",
         "--prefill-chunk", "8", "--page-size", "8"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[prefix-smoke] PASSED" in out.stdout
