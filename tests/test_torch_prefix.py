"""Prefix sharing, copy-on-write forks, grow admission and host loss on the
port against the JAX package.

Each test names its target in the JAX package.  The page pool and the
radix index are plain Python on both sides, so a random sequence of
operations must give the same return values and the same ``stats()``
exactly.  The serving tests run the port's ``ServingSession`` and the JAX
one on the same trace (reduced qwen3, params bridged from JAX, fp32 cache,
CPU) and hold tokens and every ``kv_stats()`` / ``metrics()`` counter
equal; "solo" tokens are a request decoded alone in JAX (batch 1, slab
cache).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingSession as JaxServingSession
from repro.serving import pages as jpages
import repro_torch.core as T
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingConfig, ServingSession
from repro_torch.serving import pages as tpages

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from port_testing import (  # noqa: E402, F401
    jax_solo_tokens, one_torch_thread, unoptimized_jax)

CACHE_LEN = 48
PS = 8
#: counters of metrics() that do not measure time
TIMELESS = ("seconds", "latency", "throughput", "cache", "planned_makespan")


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


def _run_pair(sides, specs, port_kw=None, **kw):
    """Serve ``specs`` ((rid, tokens, max_new, arrival[, family])) through
    the JAX session and the port's with the same config; returns (port
    session, port metrics, JAX session, JAX metrics)."""
    jmodel, params, _ = sides
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
    sess, m = _run_port(sides, specs, **kw, **port_kw)
    return sess, m, jsess, m_jax


def _run_port(sides, specs, **kw):
    """The port's half of :func:`_run_pair`: (session, metrics)."""
    kw.setdefault("replan", "off")
    kw.setdefault("cache_dtype", "float32")
    kw.setdefault("page_size", PS)
    sess = ServingSession(ServingConfig(device="cpu", **kw),
                          model=sides[2]())
    m = sess.run([Request(rid=s[0], tokens=s[1], max_new_tokens=s[2],
                          arrival=s[3],
                          family=(s[4] if len(s) > 4 else "default"))
                  for s in specs], max_steps=1000)
    return sess, m


def _tokens(sess):
    return {r: sess.results[r].tokens for r in sorted(sess.results)}


def _solo(jmodel, params, tokens, max_new, cache_len=CACHE_LEN):
    """JAX reference: the request decoded entirely alone (batch 1, slab)."""
    return jax_solo_tokens(jmodel, params, tokens, max_new,
                           cache_len=cache_len, cache_dtype=jnp.float32)


def _counters(m):
    return {k: v for k, v in m.items()
            if not any(t in k for t in TIMELESS)}


# ------------------------------------------------------- pool and index


_OPS = st.lists(st.tuples(
    st.sampled_from(["alloc", "ref", "pin", "release", "insert", "lookup",
                     "reclaim", "evict", "reclaimable"]),
    st.integers(0, 11),
    st.lists(st.integers(0, 2), max_size=11),
), max_size=60)


def _apply(pool, index, op, n, toks):
    """One operation on one side; returns its result, or the exception's
    type and message."""
    try:
        if op == "alloc":
            return pool.alloc(n % 4, rid=n)
        if op == "ref":
            return pool.ref(n)
        if op == "pin":
            return pool.pin(n)
        if op == "release":
            return pool.release([n])
        if op == "insert":
            mapped = sorted(pool._refs)
            pages = [mapped[(n + i) % len(mapped)] if mapped else 0
                     for i in range(len(toks) // 3 + 1)]
            return index.insert(toks, pages)
        if op == "lookup":
            hit = index.lookup(toks)
            return hit.pages, hit.tokens, hit.fork, hit.full
        if op == "reclaim":
            return index.reclaim(n % 4)
        if op == "evict":
            return index.evict_pages([n, (n * 7) % 12])
        return index.reclaimable()
    except ValueError as exc:
        return ("ValueError", str(exc))


def _state(pool, index):
    return (pool.stats(), index.stats(), pool._free, pool._refs,
            pool._owner, len(index), index.pages, pool.can_alloc(3))


@settings(max_examples=60, deadline=None)
@given(ops=_OPS)
def test_pool_and_index_equal_jax_on_random_operations(ops):
    """``PagePool`` + ``PrefixIndex`` (pages.py:63-456): the same random
    sequence of alloc / ref / pin / release / insert / lookup / reclaim /
    evict_pages on both packages gives equal return values (errors
    included) and equal state after every operation — LRU ticks and
    reclaim order included."""
    jpool, tpool = jpages.PagePool(12, 3), tpages.PagePool(12, 3)
    jidx, tidx = jpages.PrefixIndex(jpool), tpages.PrefixIndex(tpool)
    for op, n, toks in ops:
        assert _apply(tpool, tidx, op, n, toks) == \
            _apply(jpool, jidx, op, n, toks)
        assert _state(tpool, tidx) == _state(jpool, jidx)


def test_page_pool_refcounts_and_index_holds():
    """tests/test_serving.py:355: a shared page survives its first release
    and frees only at its last; trash and double frees fail; the index's
    hold keeps a page allocated after its slot released it, and reclaim()
    hands exactly that page back."""
    pool = tpages.PagePool(6, 8)
    pages = pool.alloc(2, rid=0)
    assert pages is not None and pool.in_use == 2
    pool.ref(pages[0])
    assert pool.refcount(pages[0]) == 2
    pool.release([pages[0]])
    assert pool.in_use == 2 and pool.refcount(pages[0]) == 1
    pool.release([pages[0]])
    assert pool.in_use == 1 and pool.refcount(pages[0]) == 0
    with pytest.raises(ValueError, match="double free"):
        pool.release([pages[0]])
    with pytest.raises(ValueError, match="trash"):
        pool.release([pool.TRASH])
    with pytest.raises(ValueError, match="unmapped"):
        pool.ref(pages[0])
    index = tpages.PrefixIndex(pool)
    held = pool.alloc(1, rid=1)
    index.insert(list(range(8)), held)
    assert pool.refcount(held[0]) == 2
    pool.release(held)  # the owning slot is evicted
    assert pool.in_use == 2, "the index's hold keeps the page allocated"
    assert index.reclaimable() == 1
    assert index.reclaim(1) == 1
    assert pool.in_use == 1 and len(index) == 0
    pool.release([pages[1]])
    assert pool.in_use == 0
    assert set(pool.stats()) == set(jpages.PagePool(6, 8).stats())


# --------------------------------------------------------------- serving


def shared_prefix_specs():
    """tests/test_serving.py:487's bursty trace: two bursts, 10 steps apart,
    of five chat requests (a 16-token shared prefix and a 4-token suffix)
    and two code requests (a 20-token prefix, which ends mid-page, and 4),
    10 new tokens each: (rid, tokens, max_new, arrival, family)."""
    rng = np.random.default_rng(17)
    chat = rng.integers(0, 256, (16,))
    code = rng.integers(0, 256, (20,))
    out = []
    for burst in range(2):
        for fam, prefix in (("chat", chat),) * 5 + (("code", code),) * 2:
            toks = np.concatenate([prefix, rng.integers(0, 256, (4,))])
            out.append((len(out), toks.astype(np.int32), 10,
                        float(10 * burst), fam))
    return out


def test_cow_fork_tokens_equal_solo_and_jax(qwen3):
    """tests/test_serving.py:396: two prompts diverging mid-page — the
    sharer maps the donor's two full pages read-shared and forks the third
    copy-on-write; both decode their solo tokens, and JAX's."""
    jmodel, params, _ = qwen3
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (24,)).astype(np.int32)
    specs = [(0, base, 5, 0.0),
             (1, np.concatenate([base[:20], rng.integers(0, 256, (4,))])
              .astype(np.int32), 5, 0.0)]
    sess, m, jsess, m_jax = _run_pair(
        qwen3, specs, max_slots=2, cache_len=CACHE_LEN, prefill_chunk=8,
        prefix_sharing=True, kv_admission="grow")
    pool = sess.batcher.pool
    assert pool.cow_forks >= 1 and pool.shared_maps >= 2
    solo = {r: _solo(jmodel, params, t, g) for r, t, g, _ in specs}
    assert _tokens(sess) == solo == _tokens(jsess)
    assert _counters(m) == _counters(m_jax)


def _run_checked(sess, specs):
    """Serve ``specs`` step by step, holding the page map after every step:
    no page mapped twice, the trash page never mapped, and the pool's
    in-use count equal to the pages mapped (grow admission maps no page
    into two slots, and sharing is off here)."""
    pool = sess.batcher.pool
    pending = sorted(specs, key=lambda s: s[3])
    i = 0
    while i < len(pending) or sess.busy:
        while i < len(pending) and pending[i][3] <= sess.steps:
            r, t, g, a = pending[i][:4]
            sess.submit(Request(rid=r, tokens=t, max_new_tokens=g, arrival=a))
            i += 1
        sess.step()
        mapped = [p for pages in sess.batcher._slot_pages.values()
                  for p in pages]
        assert len(mapped) == len(set(mapped)), "double-mapped page"
        assert pool.TRASH not in mapped
        assert pool.in_use == len(mapped)
        assert sess.steps < 500, "grow pressure deadlocked the session"
    return sess.metrics()


def test_grow_admission_under_pool_pressure(qwen3):
    """tests/test_serving.py:434: grow-on-write with 4 usable pages for 3
    requests that each reach 3 pages — decode grows pages lazily, pressure
    pauses or preempts instead of double-mapping, preempted requests
    regenerate their solo tokens, every page comes back, and every counter
    is JAX's."""
    jmodel, params, port = qwen3
    rng = np.random.default_rng(9)
    specs = [(i, rng.integers(0, 256, (5,)).astype(np.int32), 16, 0.0)
             for i in range(3)]
    kw = dict(max_slots=2, cache_len=CACHE_LEN, page_size=PS, kv_pages=5,
              kv_admission="grow", cache_dtype="float32", replan="off")
    sess = ServingSession(ServingConfig(device="cpu", **kw), model=port())
    m = _run_checked(sess, specs)
    pool = sess.batcher.pool
    assert pool.grow_allocs > 0
    assert pool.grow_defers > 0 or sess.batcher.preemptions > 0
    assert pool.in_use == 0 and len(sess.results) == 3
    solo = {r: _solo(jmodel, params, t, g) for r, t, g, _ in specs}
    assert _tokens(sess) == solo
    jsess = JaxServingSession(JaxServingConfig(kv_layout="paged", **kw),
                              model=jmodel, params=params)
    m_jax = jsess.run([JaxRequest(rid=r, tokens=jnp.asarray(t),
                                  max_new_tokens=g, arrival=a)
                       for r, t, g, a in specs])
    assert _tokens(jsess) == solo
    assert _counters(m) == _counters(m_jax)


def test_prefix_sharing_acceptance_hit_rate_and_memory(qwen3):
    """tests/test_serving.py:487: on the bursty shared-prefix trace,
    sharing with grow admission gives the unshared paged run's tokens and
    the slab run's, a hit rate above 0.5 and a lower page high-water, and
    every kv_stats() and metrics() counter of each paged run is JAX's."""
    specs = shared_prefix_specs()
    paged = dict(max_slots=6, cache_len=CACHE_LEN, prefill_chunk=8)
    shared, m_shared, jshared, mj_shared = _run_pair(
        qwen3, specs, prefix_sharing=True, kv_admission="grow", **paged)
    plain, m_plain, jplain, mj_plain = _run_pair(qwen3, specs, **paged)
    assert _tokens(shared) == _tokens(plain) == _tokens(jshared)
    assert _tokens(plain) == _tokens(jplain)
    slab = ServingSession(ServingConfig(
        device="cpu", max_slots=6, cache_len=CACHE_LEN, replan="off",
        cache_dtype="float32", kv_layout="slab"), model=qwen3[2]())
    slab.run([Request(rid=s[0], tokens=s[1], max_new_tokens=s[2],
                      arrival=s[3], family=s[4]) for s in specs],
             max_steps=1000)
    assert _tokens(slab) == _tokens(shared)
    assert m_shared["prefix_hit_rate"] > 0.5
    assert m_shared["kv_page_hw"] < m_plain["kv_page_hw"]
    assert m_shared["kv_cow_forks"] >= 1
    assert shared.batcher.kv_stats() == jshared.batcher.kv_stats()
    assert plain.batcher.kv_stats() == jplain.batcher.kv_stats()
    assert _counters(m_shared) == _counters(mj_shared)
    assert _counters(m_plain) == _counters(mj_plain)


def test_shared_trace_under_grow_pressure_keeps_solo_tokens(qwen3):
    """The same trace with sharing and grow admission in a 12-page pool:
    admission reclaims index pages and growth preempts, and every request
    still gets its solo tokens.  The JAX batcher does not here (ROADMAP
    queue 3): its admission's reclaim frees a page that its own prefix
    lookup just matched and hands it back as the same request's private
    page or fork target, which the port's admission holds against."""
    jmodel, params, _ = qwen3
    specs = shared_prefix_specs()
    kw = dict(max_slots=6, cache_len=CACHE_LEN, prefill_chunk=8,
              prefix_sharing=True, kv_admission="grow")
    sess, m, jsess, m_jax = _run_pair(qwen3, specs, kv_pages=12, **kw)
    free, _ = _run_port(qwen3, specs, **kw)
    assert m["kv_preemptions"] > 0 and m["prefix_index_reclaimed"] > 0
    solo = {r: _solo(jmodel, params, t, g) for r, t, g, _, _ in specs}
    assert _tokens(sess) == _tokens(free) == solo
    # the witness of the reference's defect (ROADMAP queue 3): some of its
    # requests leave their solo tokens; which ones follows its reclaim order
    wrong = {r for r, t in _tokens(jsess).items() if t != solo[r]}
    assert wrong


def test_host_failed_requeues_and_regenerates_exactly(qwen3):
    """tests/test_faults.py:309: a host loss two steps into a chunked,
    shared-prefix run bumps every resident request (decoding slots and
    streaming chunk jobs) to the front of the queue and drops the prefix
    index; the run still gives the uninterrupted run's tokens, and its
    host-loss counters and every other counter are JAX's."""
    jmodel, params, port = qwen3
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, size=8).astype(np.int32)
               for _ in range(5)]
    kw = dict(max_slots=2, cache_len=64, prefix_sharing=True,
              prefill_chunk=8, replan="off", page_size=PS,
              cache_dtype="float32")

    def drive(sess, make, fail):
        for i, p in enumerate(prompts):
            sess.submit(make(i, p))
        for _ in range(2):
            sess.step()
        n = sess.host_failed() if fail else 0
        while sess.busy:
            sess.step()
        return n, sess.metrics()

    def port_req(i, p):
        return Request(rid=i, tokens=p, max_new_tokens=5, family="t")

    def jax_req(i, p):
        return JaxRequest(rid=i, tokens=jnp.asarray(p), max_new_tokens=5,
                          family="t")

    ref = ServingSession(ServingConfig(device="cpu", **kw), model=port())
    drive(ref, port_req, False)
    sess = ServingSession(ServingConfig(device="cpu", **kw), model=port())
    n, m = drive(sess, port_req, True)
    jsess = JaxServingSession(JaxServingConfig(kv_layout="paged", **kw),
                              model=jmodel, params=params)
    n_jax, m_jax = drive(jsess, jax_req, True)
    assert n >= 1 and n == n_jax
    assert _tokens(sess) == _tokens(ref) == _tokens(jsess)
    assert m["host_loss_events"] == 1 and m["host_loss_requeued"] == n
    assert m["kv_host_loss_preemptions"] >= 1
    assert _counters(m) == _counters(m_jax)


def _plans_per_step(sess, specs, make):
    """Step ``sess`` through ``specs``; after each step that replanned, the
    plan (JSON, without its planning time)."""
    plans, i, seen = [], 0, 0
    pending = sorted(specs, key=lambda s: s[3])
    while i < len(pending) or sess.busy:
        while i < len(pending) and pending[i][3] <= sess.steps:
            sess.submit(make(*pending[i]))
            i += 1
        sess.step()
        if len(sess.replans) > seen:
            seen = len(sess.replans)
            d = json.loads(sess.current_plan.to_json())
            d.pop("planning_seconds")
            plans.append(d)
        assert sess.steps < 1000
    return plans


def _replan_kinds(sess):
    return [(r.mode, r.event.kind, tuple(e.kind for e in r.events))
            for r in sess.replans]


def test_planner_with_chunking_and_sharing_equals_jax(qwen3):
    """With chunked prefill and prefix sharing on, the planner's graph takes
    the batcher's chunk and its observed hit rate (session.py:262-272): on
    the shared-prefix trace the replans, their modes and event kinds, and
    every plan equal the JAX session's (the port given the reference's
    hardware and cluster values)."""
    jmodel, params, port = qwen3
    specs = shared_prefix_specs()
    ref_c = R.ClusterSpec(n_devices=16, island_size=8, mem_bytes=96e9)
    kw = dict(max_slots=6, cache_len=CACHE_LEN, page_size=PS,
              prefill_chunk=8, prefix_sharing=True, kv_admission="grow",
              cache_dtype="float32", replan="mix")
    jsess = JaxServingSession(JaxServingConfig(kv_layout="paged", **kw),
                              model=jmodel, params=params)
    want = _plans_per_step(jsess, specs, lambda r, t, g, a, f: JaxRequest(
        rid=r, tokens=jnp.asarray(t), max_new_tokens=g, family=f))
    sess = ServingSession(ServingConfig(
        device="cpu", cluster=T.ClusterSpec(**dataclasses.asdict(ref_c)),
        **kw), model=port())
    ps = sess.planner_session
    ps.config = dataclasses.replace(
        ps.config, hw=T.HardwareSpec(**dataclasses.asdict(R.V5E)))
    got = _plans_per_step(sess, specs, lambda r, t, g, a, f: Request(
        rid=r, tokens=t, max_new_tokens=g, family=f))
    assert sess.batcher.prefill_chunk == 8
    assert sess.batcher.observed_hit_rate() > 0.5
    assert _replan_kinds(sess) == _replan_kinds(jsess)
    assert len(got) == len(sess.replans) >= 2
    assert got == want
    assert _tokens(sess) == _tokens(jsess)


def test_can_admit_and_join_equal_jax(qwen3):
    """``can_admit`` and ``join`` (batcher.py:657,705): a pool of 4 usable
    pages admits one 20-token request by ``join`` (3 pages reserved), then
    refuses a second until the first is gone — counting one deferral
    event however often it is asked — exactly as the JAX batcher does."""
    from repro.serving.batcher import ContinuousBatcher as JaxBatcher
    from repro_torch.serving.batcher import ContinuousBatcher

    jmodel, params, port = qwen3
    toks = np.arange(20, dtype=np.int32)
    jb = JaxBatcher(jmodel, params, max_slots=2, cache_len=CACHE_LEN,
                    kv_layout="paged", page_size=PS, kv_pages=5,
                    cache_dtype=jnp.float32)
    tb = ContinuousBatcher(port(), max_slots=2, cache_len=CACHE_LEN,
                           page_size=PS, kv_pages=5,
                           cache_dtype=torch.float32)
    seen = {}
    for name, b, make in (
            ("jax", jb, lambda r: JaxRequest(rid=r, tokens=jnp.asarray(toks),
                                             max_new_tokens=4)),
            ("port", tb, lambda r: Request(rid=r, tokens=toks,
                                           max_new_tokens=4))):
        first, second = make(0), make(1)
        assert b.can_admit(first)
        slot = b.join(first)
        out = [slot, b.can_admit(second), b.can_admit(second),
               b.pool.defers, b.pool.in_use]
        while b.n_active:
            b.step()
        out += [b.can_admit(second), b.pool.in_use, b.pool.defers]
        seen[name] = out
    assert seen["port"] == seen["jax"] == [0, False, False, 1, 3, True, 0, 1]
