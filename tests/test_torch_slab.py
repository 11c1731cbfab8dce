"""The slab KV layout on the port against the JAX package, on the CPU (fp32).

* Full-attention slab ``attn_decode`` (GQA 4:2, ragged per-row positions,
  a stale row at ``pos == S``) against JAX's slab branch: outputs within
  1e-5, every cache entry within 1e-5 (the new K/V are computed in
  another order) and each row's write at its own position, the stale
  row's clamped to the last one as JAX's ``dynamic_update_slice`` clamps
  it;
* the slab ``CacheIO`` writes (batch-1 and stacked) and ``read_slot``;
* ``ServingSession(kv_layout="slab")`` with ``batched_prefill`` False and
  True on reduced qwen3 (a 300-token prompt: the flash path's plain
  version), xlstm, recurrentgemma and seamless-m4t-medium (frames of
  ``CACHE_LEN // 4``), on the staggered 2-slot trace of
  ``tests/test_serving.py:41`` plus requests that share a stacked prefill
  and fill their slab to the last position (a freed row then rides along
  at ``pos == cache_len``):
  tokens equal to JAX's slab session's, and ``kv_stats()`` and every
  ``metrics()`` counter that is not a time equal to JAX's;
* slab with ``prefill_chunk``, ``kv_admission="grow"`` or
  ``prefix_sharing`` raises JAX's ``ValueError``, in the config and in the
  batcher.

The JAX sessions jit their model functions; one module-scoped model per
arch serves both prefill settings.
"""

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
from repro_torch.serving.batcher import (CacheIO, ContinuousBatcher,
                                         read_slot, write_slot, write_slots)

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401

CACHE_LEN = 48
#: metrics() keys that hold a time (or the planner cache, off here)
TIMED = ("seconds", "latency", "throughput", "cache", "planned_makespan")



def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------- the decode


def test_slab_attn_decode_matches_jax_with_a_stale_row():
    B, H, K, hd, S, d = 4, 4, 2, 16, 12, 32
    rng = np.random.default_rng(0)
    p = {k: _np(rng, shape) * 0.2 for k, shape in
         (("wq", (d, H * hd)), ("wk", (d, K * hd)), ("wv", (d, K * hd)),
          ("wo", (H * hd, d)))}
    x = _np(rng, (B, 1, d))
    ck, cv = _np(rng, (B, K, S, hd)), _np(rng, (B, K, S, hd))
    pos = np.asarray([0, 5, S - 1, S], np.int32)  # the last row is stale
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rope_theta=1e4, qk_norm=True)
    yj, kj, vj = jax.jit(lambda p, x, ck, cv, pos: jatt.attn_decode(
        p, x, ck, cv, pos, **kw))(*(jax.tree.map(jnp.asarray, a)
                                    for a in (p, x, ck, cv, pos)))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y, k2, v2 = tatt.attn_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tk, tv, torch.from_numpy(pos), **kw)
    assert k2 is tk and v2 is tv, "the slab is updated in place"
    assert float(np.abs(y.numpy() - np.asarray(yj)).max()) < 1e-5
    np.testing.assert_allclose(tk.numpy(), np.asarray(kj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    # the stale row's write landed at S-1, the others at their positions
    changed = (tk.numpy() != ck).any(axis=(1, 3))
    assert changed.sum(axis=1).tolist() == [1, 1, 1, 1]
    assert changed[3, S - 1] and changed[2, S - 1] and changed[1, 5]


def test_slab_cache_io_writes_and_reads_rows():
    rng = np.random.default_rng(1)
    cache = [{"k": torch.zeros(4, 2, 6, 3), "h": torch.zeros(4, 5)}]
    page = [{"k": torch.from_numpy(_np(rng, (2, 2, 6, 3))).double(),
             "h": torch.from_numpy(_np(rng, (2, 5)))}]
    io = CacheIO()
    assert not io.paged
    io.write_prefill(cache, page, [3, 1])
    one = [{"k": torch.zeros(4, 2, 6, 3), "h": torch.zeros(4, 5)}]
    write_slot(one, [{k: v[:1] for k, v in page[0].items()}], 3)
    write_slot(one, [{k: v[1:] for k, v in page[0].items()}], 1)
    for key in ("k", "h"):
        assert cache[0][key].dtype == torch.float32
        assert torch.equal(cache[0][key], one[0][key])
        assert torch.equal(io.read_slot(cache, 1)[0][key],
                           page[0][key][1:].float())
    stacked = [{"k": torch.zeros(4, 2, 6, 3), "h": torch.zeros(4, 5)}]
    write_slots(stacked, page, [3, 1])
    assert all(torch.equal(stacked[0][k], cache[0][k]) for k in ("k", "h"))
    assert torch.equal(read_slot(cache, 0)[0]["h"], torch.zeros(1, 5))
    with pytest.raises(ValueError, match="slab-only"):
        CacheIO([{"k": "kv0"}]).read_slot(cache, 0)


# ----------------------------------------------------------------- serving

ARCHS = ("qwen3-0.6b", "xlstm-125m", "recurrentgemma-9b",
         "seamless-m4t-medium")


def _specs(arch, cfg):
    """(rid, tokens, max_new, arrival, extras): tests/test_serving.py:41's
    staggered trace; a second 5-token prompt arriving with the first (one
    stacked prefill of two under ``batched_prefill``) that fills a 48-slot
    slab (5 + 44 - 1 positions); and for qwen3 a 300-token prompt that
    fills its 320-slot slab (300 + 21 - 1).  A request that fills its slab
    leaves its freed row riding along at ``pos == cache_len``."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(5):
        p, g = (5, 9, 7, 12)[i % 4], (4, 7, 5, 6)[i % 4]
        out.append((i, rng.integers(0, 256, (p,)).astype(np.int32), g,
                    2.0 * i))
    out.append((5, rng.integers(0, 256, (5,)).astype(np.int32),
                CACHE_LEN - 4, 0.0))
    if arch == "qwen3-0.6b":
        out.append((6, rng.integers(0, 256, (300,)).astype(np.int32), 21,
                    3.0))
    frames = []
    for _ in out:
        frames.append({"frames": _np(rng, (CACHE_LEN // 4, cfg.d_model))}
                      if cfg.is_encdec else {})
    return [s + (e,) for s, e in zip(out, frames)]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced(jax_get_arch(arch)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    model = bridge.load_jax_params(
        build_model(reduced(get_arch(arch)), ShardingConfig(use_kernels=True),
                    device="cpu"),
        jax.tree.map(np.asarray, params))
    return arch, jmodel, params, model, _specs(arch, jmodel.cfg)


@pytest.mark.parametrize("batched", [False, True],
                         ids=["batch1_prefill", "stacked_prefill"])
def test_slab_session_equals_jax(served, batched):
    arch, jmodel, params, model, specs = served
    kw = dict(max_slots=2, replan="off", kv_layout="slab",
              cache_dtype="float32", batched_prefill=batched,
              cache_len=320 if arch == "qwen3-0.6b" else CACHE_LEN)
    jsess = JaxServingSession(JaxServingConfig(**kw), model=jmodel,
                              params=params)
    m_jax = jsess.run([JaxRequest(rid=r, tokens=jnp.asarray(t),
                                  max_new_tokens=g, arrival=a,
                                  extras={k: jnp.asarray(v)
                                          for k, v in e.items()})
                       for r, t, g, a, e in specs], max_steps=500)
    sess = ServingSession(ServingConfig(device="cpu", **kw), model=model)
    m = sess.run([Request(rid=r, tokens=t, max_new_tokens=g, arrival=a,
                          extras=e) for r, t, g, a, e in specs],
                 max_steps=500)
    got = {r: sess.results[r].tokens for r in sess.results}
    assert len(got) == len(specs)
    assert got == {r: jsess.results[r].tokens for r in jsess.results}
    b = sess.batcher
    assert b.kv_stats() == jsess.batcher.kv_stats()
    assert b.kv_stats()["kv_layout"] == "slab" and len(b.kv_stats()) == 3
    assert b.pool is None and b.kv_page_bytes == 0
    assert b.io.paged is False
    counters = {k: v for k, v in m.items() if not any(t in k for t in TIMED)}
    assert counters == {k: m_jax[k] for k in counters}
    # one batch-1 prefill per request, or the first two stacked
    assert m["prefill_calls"] == len(specs) - batched


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=16), "prefill_chunk requires kv_layout='paged'"),
    (dict(kv_admission="grow"), "kv_admission='grow' requires"),
    (dict(prefix_sharing=True), "prefix_sharing requires"),
])
def test_slab_refuses_page_only_options_like_jax(kw, match):
    for cfg in (JaxServingConfig, ServingConfig):
        with pytest.raises(ValueError, match=match):
            cfg(kv_layout="slab", **kw)
    model = build_model(reduced(get_arch("qwen3-0.6b")), device="cpu")
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        ContinuousBatcher(model, max_slots=1, cache_len=8, kv_layout="slab",
                          **kw)
    with pytest.raises(ValueError, match="kv_layout"):
        ContinuousBatcher(model, max_slots=1, cache_len=8, kv_layout="Slab")
