"""The port's serving session against the JAX one.

The load-bearing contract of ``tests/test_serving.py:95``: a request decoded
in a shared continuous batch (joined late, neighbours evicted under it,
slots and pages reused) produces exactly the tokens it produces alone — and
here, exactly the tokens the JAX session produces on the same params, with
the same page accounting.  Reduced qwen3, fp32 cache, on the CPU; the port
runs with kernels on, so its attention goes through the kernels' plain
versions, and a 300-token prompt takes the flash path.

Reduced qwen2-moe is held to the JAX session too.  Its decode is not
batch-independent: every row of the fixed-shape decode batch, a freed
slot's stale row included, competes for expert capacity in row order.  So
JAX-vs-port token equality is defined where every slot is live at every
step (equal requests, all arriving at once), which is held exactly; the
staggered trace is held as well, because with 2 slots a decode step's
capacity (2) covers every row an expert can get.

The multimodal archs (reduced seamless-m4t-medium with frames, reduced
pixtral-12b with a 16-position patch stub) and reduced glm4-9b are held
to the JAX session on the same staggered trace: tokens, solo decoding and
every page counter.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro.serving import ServingSession as JaxServingSession
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.launch.events import RequestQueueSource
from repro_torch.models import build_model
from repro_torch.serving import (
    MixTracker,
    Request,
    RequestQueue,
    ServingConfig,
    ServingSession,
)
from repro_torch.serving.pages import PagePool

from port_testing import (  # noqa: F401
    jax_solo_tokens, one_torch_thread, unoptimized_jax)

CACHE_LEN = 48
KV_KEYS = ("kv_slab_tokens", "kv_page_size", "kv_pages", "kv_pages_in_use",
           "kv_page_hw", "kv_page_hw_tokens", "kv_defers")


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_reduced(jax_get_arch("qwen3-0.6b")))
    params = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)

    def port(use_kernels=True):
        model = build_model(reduced(get_arch("qwen3-0.6b")),
                            ShardingConfig(use_kernels=use_kernels),
                            device="cpu")
        return bridge.load_jax_params(model, np_params)

    return jmodel, params, port


def _specs(n, *, seed=7, long_prompt=0):
    """(rid, tokens, max_new, arrival) of n requests with varied lengths and
    staggered arrivals (test_serving.py:40), plus one long prompt."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p, g = (5, 9, 7, 12)[i % 4], (4, 7, 5, 6)[i % 4]
        out.append((i, rng.integers(0, 256, (p,)).astype(np.int32), g, 2.0 * i))
    if long_prompt:
        out.append((n, rng.integers(0, 256, (long_prompt,)).astype(np.int32),
                    5, 1.0))
    return out


def _port_reqs(specs):
    return [Request(rid=r, tokens=t, max_new_tokens=g, arrival=a)
            for r, t, g, a in specs]


def _jax_reqs(specs):
    return [JaxRequest(rid=r, tokens=jnp.asarray(t), max_new_tokens=g,
                       arrival=a) for r, t, g, a in specs]


def _solo_tokens(jmodel, params, tokens, max_new, cache_dtype):
    """JAX reference: the request decoded entirely alone (batch 1, slab)."""
    return jax_solo_tokens(jmodel, params, tokens, max_new,
                           cache_len=CACHE_LEN, cache_dtype=cache_dtype)


@pytest.fixture(scope="module")
def jax_continuous(models):
    jmodel, params, _ = models
    specs = _specs(5, long_prompt=300)
    sess = JaxServingSession(
        JaxServingConfig(max_slots=2, cache_len=320, replan="off",
                         kv_layout="paged", page_size=8,
                         cache_dtype="float32"),
        model=jmodel, params=params,
    )
    m = sess.run(_jax_reqs(specs), max_steps=500)
    m["kv_page_bytes"] = sess.batcher.kv_page_bytes
    return specs, {r: sess.results[r].tokens for r in sess.results}, m


@pytest.fixture(scope="module")
def moe_models():
    jmodel = jax_build_model(jax_reduced(jax_get_arch("qwen2-moe-a2.7b")))
    params = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)

    def port(use_kernels=True):
        model = build_model(reduced(get_arch("qwen2-moe-a2.7b")),
                            ShardingConfig(use_kernels=use_kernels),
                            device="cpu")
        return bridge.load_jax_params(model, np_params)

    return jmodel, params, port


def _run_both(models, specs, *, max_slots, cache_len, use_kernels):
    jmodel, params, port = models
    jsess = JaxServingSession(
        JaxServingConfig(max_slots=max_slots, cache_len=cache_len,
                         replan="off", kv_layout="paged", page_size=8,
                         cache_dtype="float32"),
        model=jmodel, params=params,
    )
    m_jax = jsess.run(_jax_reqs(specs), max_steps=500)
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=max_slots, cache_len=cache_len,
                      page_size=8, cache_dtype="float32"),
        model=port(use_kernels),
    )
    m = sess.run(_port_reqs(specs), max_steps=500)
    want = {r: jsess.results[r].tokens for r in jsess.results}
    got = {r: sess.results[r].tokens for r in sess.results}
    return got, want, m, m_jax


@pytest.mark.parametrize("use_kernels", [True, False])
def test_moe_all_live_equivalence_vs_jax(moe_models, use_kernels):
    """Two 300-token prompts in two slots, arriving together, generating
    the same count: one stacked prefill (600 tokens through the flash path
    and one dispatch) and every decode step with both rows live."""
    rng = np.random.default_rng(11)
    specs = [(i, rng.integers(0, 256, (300,)).astype(np.int32), 6, 0.0)
             for i in range(2)]
    got, want, m, m_jax = _run_both(moe_models, specs, max_slots=2,
                                    cache_len=320, use_kernels=use_kernels)
    assert len(got) == 2 and got == want
    assert m["prefill_calls"] == m_jax["prefill_calls"] == 1
    assert m["decode_steps"] == m_jax["decode_steps"] == 5


def test_moe_staggered_equivalence_vs_jax(moe_models):
    """The staggered 2-slot trace (joins, evictions, slot and page reuse)
    gives JAX's tokens: at 2 slots a decode step's capacity is 2, so a
    stale row can never take a live row's place in an expert."""
    got, want, m, m_jax = _run_both(moe_models, _specs(5, long_prompt=300),
                                    max_slots=2, cache_len=320,
                                    use_kernels=True)
    assert got == want
    for key in KV_KEYS + ("decode_steps", "prefill_calls", "output_tokens"):
        assert m[key] == m_jax[key], key


@pytest.mark.parametrize("use_kernels", [True, False])
def test_continuous_equivalence_vs_jax(models, jax_continuous, use_kernels):
    """Two slots force queueing, eviction, slot reuse and page recycling."""
    _, _, port = models
    specs, want, m_jax = jax_continuous
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=2, cache_len=320, page_size=8,
                      cache_dtype="float32"),
        model=port(use_kernels),
    )
    m = sess.run(_port_reqs(specs), max_steps=500)
    got = {r: sess.results[r].tokens for r in sess.results}
    assert got == want
    for key in KV_KEYS + ("decode_steps", "prefill_calls", "output_tokens"):
        assert m[key] == m_jax[key], key
    assert sess.batcher.kv_page_bytes == m_jax["kv_page_bytes"]


# the reference decode path rounds attention weights to the cache dtype
# like the JAX slab decode (exact at bf16); the kernels keep them in fp32,
# as the Pallas kernel does, so they are held to the fp32-cache reference
@pytest.mark.parametrize("use_kernels,cache_dtype", [(False, "bfloat16"),
                                                     (True, "float32")])
def test_page_pool_exhaustion_defers_admission(models, use_kernels,
                                               cache_dtype):
    """A small page pool defers admission instead of corrupting state: no
    physical page is ever double-mapped, eviction returns pages, and every
    request still completes with its solo tokens (test_serving.py:167)."""
    jmodel, params, port = models
    specs = _specs(5)
    solo = {r: _solo_tokens(jmodel, params, t, g, cache_dtype)
            for r, t, g, _ in specs}
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=3, cache_len=CACHE_LEN,
                      page_size=8, kv_pages=5,
                      cache_dtype=cache_dtype),
        model=port(use_kernels),
    )
    pool = sess.batcher.pool
    pending = sorted(_port_reqs(specs), key=lambda r: r.arrival)
    i = 0
    while i < len(pending) or sess.busy:
        while i < len(pending) and pending[i].arrival <= sess.steps:
            sess.submit(pending[i])
            i += 1
        sess.step()
        mapped = [p for pages in sess.batcher._slot_pages.values()
                  for p in pages]
        assert len(mapped) == len(set(mapped)), "double-mapped page"
        assert pool.TRASH not in mapped
        assert pool.in_use == len(mapped)
        if sess.steps > 500:
            raise AssertionError("exhausted pool deadlocked the session")
    assert pool.defers > 0, "the small pool must defer at least once"
    assert pool.in_use == 0, "eviction must return every page"
    assert {r: sess.results[r].tokens for r in sess.results} == solo


def test_serving_config_cache_geometry_validation(models):
    """test_serving.py:214 — the slab-sizing bug class is rejected at config
    construction, and per-request caps are enforced at submit."""
    _, _, port = models
    with pytest.raises(ValueError, match="cache_len"):
        ServingConfig(cache_len=32, max_prompt_len=24, max_new_tokens=16)
    ServingConfig(cache_len=39, max_prompt_len=24, max_new_tokens=16)
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        ServingConfig(kv_layout="slab", prefill_chunk=16)
    with pytest.raises(ValueError, match="kv_layout"):
        ServingConfig(kv_layout="Paged")
    model = port()
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=2, cache_len=48,
                      max_prompt_len=10, max_new_tokens=8),
        model=model,
    )
    with pytest.raises(ValueError, match="admissible max"):
        sess.submit(Request(rid=0, tokens=np.zeros(12, np.int32),
                            max_new_tokens=4))
    with pytest.raises(ValueError, match="config cap"):
        sess.submit(Request(rid=1, tokens=np.zeros(8, np.int32),
                            max_new_tokens=9))
    assert sess.submit(Request(rid=2, tokens=np.zeros(8, np.int32),
                               max_new_tokens=8))
    tiny = ServingSession(
        ServingConfig(device="cpu", max_slots=2, cache_len=48, page_size=8,
                      kv_pages=3),
        model=model,
    )
    with pytest.raises(ValueError, match="pool capacity"):
        tiny.submit(Request(rid=3, tokens=np.zeros(12, np.int32),
                            max_new_tokens=8))
    assert tiny.submit(Request(rid=4, tokens=np.zeros(6, np.int32),
                               max_new_tokens=8))


def test_oversized_request_and_bad_policy_fail_fast(models):
    """test_serving.py:335."""
    _, _, port = models
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=2, cache_len=16), model=port())
    toks = np.zeros(10, np.int32)
    with pytest.raises(ValueError, match="cache_len"):
        sess.submit(Request(rid=0, tokens=toks, max_new_tokens=8))
    assert sess.submit(Request(rid=1, tokens=toks, max_new_tokens=7))
    with pytest.raises(ValueError, match="admission"):
        ServingConfig(admission="Static")
    with pytest.raises(ValueError, match="replan"):
        ServingConfig(replan="none")


def _mix_shift_trace(sess, make):
    """tests/test_serving.py:267's trace: three long chat requests, a
    fourth (churn inside the quantized mix), a short code request joining
    mid-trace and leaving (the recurring chat-only mix), then the drain.
    Returns the replan count after each of the first three steps."""
    seen = []
    for rid in range(3):
        sess.submit(make(rid, 6, 40, "chat"))
    sess.step()
    seen.append(len(sess.replans))
    sess.submit(make(3, 6, 40, "chat"))
    sess.step()
    seen.append(len(sess.replans))
    sess.submit(make(4, 20, 4, "code"))
    sess.step()
    seen.append(len(sess.replans))
    while sess.busy:
        sess.step()
    return seen


def _replan_kinds(sess):
    return [(r.mode, type(r.event).__name__, r.event.kind,
             tuple(e.kind for e in r.events)) for r in sess.replans]


def test_mix_shift_replans_equal_jax_and_leave_tokens_alone(models):
    """One replan per mix shift, none for churn, a full replan for a new
    family and a PlanCache hit for a recurring mix — mode for mode and
    event kind for event kind the JAX session's on the same trace; the
    tokens are JAX's, and the same as with ``replan="off"``."""
    jmodel, params, port = models
    rng = np.random.default_rng(3)
    prompts = {rid: rng.integers(0, 256, (n,)).astype(np.int32)
               for rid, n in enumerate((6, 6, 6, 6, 20))}

    jsess = JaxServingSession(
        JaxServingConfig(max_slots=8, cache_len=CACHE_LEN, replan="mix",
                         cache_dtype="float32"),
        model=jmodel, params=params)
    jseen = _mix_shift_trace(jsess, lambda rid, p, g, fam: JaxRequest(
        rid=rid, tokens=jnp.asarray(prompts[rid]), max_new_tokens=g,
        family=fam))
    runs = {}
    for replan in ("mix", "off"):
        sess = ServingSession(
            ServingConfig(device="cpu", max_slots=8, cache_len=CACHE_LEN,
                          replan=replan, cache_dtype="float32"),
            model=port())
        seen = _mix_shift_trace(sess, lambda rid, p, g, fam: Request(
            rid=rid, tokens=prompts[rid], max_new_tokens=g, family=fam))
        runs[replan] = sess, seen
    sess, seen = runs["mix"]
    assert seen == jseen == [1, 1, 2]
    assert _replan_kinds(sess) == _replan_kinds(jsess)
    assert [r.mode for r in sess.replans][:3] == ["full", "full", "hit"]
    assert sess.replans[2].event.kind == "request_completed"
    m = sess.metrics()
    assert m["replans"] == len(jsess.replans) and m["cache"]["hits"] >= 1
    assert m["busy_seconds"] == pytest.approx(
        m["prefill_seconds"] + m["decode_seconds"] + m["planning_seconds"])
    assert m["planned_makespan_ms"] > 0
    tokens = {r: res.tokens for r, res in sess.results.items()}
    off, _ = runs["off"]
    assert tokens == {r: res.tokens for r, res in off.results.items()}
    assert tokens == {r: res.tokens for r, res in jsess.results.items()}
    assert off.replans == [] and "cache" not in off.metrics()


def test_replan_initial_plans_once_and_cooldown_coalesces(models):
    """``"initial"`` plans the first mix only; a cooldown holds the burst
    of shifts until its window has passed (tests/test_serving.py's
    policies, against the JAX session)."""
    jmodel, params, port = models
    rng = np.random.default_rng(4)
    prompts = {rid: rng.integers(0, 256, (n,)).astype(np.int32)
               for rid, n in enumerate((6, 6, 6, 6, 20))}
    for kw in (dict(replan="initial"), dict(replan="mix", replan_cooldown=3)):
        jsess = JaxServingSession(
            JaxServingConfig(max_slots=8, cache_len=CACHE_LEN,
                             cache_dtype="float32", **kw),
            model=jmodel, params=params)
        _mix_shift_trace(jsess, lambda rid, p, g, fam: JaxRequest(
            rid=rid, tokens=jnp.asarray(prompts[rid]), max_new_tokens=g,
            family=fam))
        sess = ServingSession(
            ServingConfig(device="cpu", max_slots=8, cache_len=CACHE_LEN,
                          cache_dtype="float32", **kw),
            model=port())
        _mix_shift_trace(sess, lambda rid, p, g, fam: Request(
            rid=rid, tokens=prompts[rid], max_new_tokens=g, family=fam))
        assert _replan_kinds(sess) == _replan_kinds(jsess)
        if kw["replan"] == "initial":
            assert len(sess.replans) == 1


def test_apply_lease_replans_live_traffic(models):
    """A lease with live traffic replans the current mix over the new view;
    with nothing to plan it is adopted silently, as in the JAX session."""
    _, _, port = models
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=4, cache_len=CACHE_LEN),
        model=port())
    lease = dataclasses.replace(sess.config.cluster, n_devices=8)
    assert sess.apply_lease(lease) is None  # no mix yet: adopted
    assert sess.planner_session.cluster == lease and not sess.replans
    sess.submit(Request(rid=0, tokens=np.arange(6), max_new_tokens=8))
    sess.step()
    assert sess.current_plan.n_devices == 8
    rec = sess.apply_lease(sess.config.cluster)
    assert rec is sess.replans[-1] and rec.event.kind == "lease_changed"
    assert sess.current_plan.n_devices == 16
    off = ServingSession(ServingConfig(device="cpu", replan="off"),
                         model=port())
    assert off.apply_lease(lease) is None and off.current_plan is None


def test_served_session_is_freed_without_the_cycle_collector(models):
    """A replanning session holds no reference cycle: dropped, it frees its
    model at once (a cycle through the planner's graph factory kept each
    served model on the card until the collector ran)."""
    _, _, port = models
    sess = ServingSession(ServingConfig(device="cpu", max_slots=2,
                                        cache_len=CACHE_LEN), model=port())
    sess.submit(Request(rid=0, tokens=np.arange(6), max_new_tokens=4))
    sess.step()
    assert sess.replans
    alive = weakref.ref(sess.model)
    gc.disable()
    try:
        del sess
        assert alive() is None
    finally:
        gc.enable()


def test_session_rejects_a_model_on_another_device(models):
    _, _, port = models
    with pytest.raises(ValueError, match="device|lives"):
        ServingSession(ServingConfig(device="cpu"),
                       model=type("M", (), {"device": torch.device("meta")})())


def test_page_pool_refcounts_free_only_at_zero():
    """test_serving.py:355 (the pool half; the prefix index is ported with
    prefix sharing)."""
    pool = PagePool(6, 8)
    pages = pool.alloc(2, rid=0)
    assert pages is not None and pool.in_use == 2
    assert pool.refcount(pages[0]) == 1
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
    pool.release([pages[1]])
    assert pool.in_use == 0 and pool.high_water == 2


def test_admission_control_and_events():
    """test_serving.py:316."""
    q = RequestQueue(max_pending=2)
    src = RequestQueueSource(q)
    toks = np.zeros(4, np.int32)
    assert q.submit(Request(rid=0, tokens=toks, max_new_tokens=2))
    assert q.submit(Request(rid=1, tokens=toks, max_new_tokens=2))
    assert not q.submit(Request(rid=2, tokens=toks, max_new_tokens=2))
    assert q.rejected == 1
    r0 = q.pop()
    q.note_completion(r0, generated=2)
    kinds = [e.kind for e in src.poll()]
    assert kinds == ["request_arrived", "request_arrived", "request_completed"]
    assert src.poll() == []


def test_mix_tracker_quantization():
    """test_serving.py:548."""
    mix = MixTracker()
    for rid, p in enumerate((5, 7, 30)):
        mix.submitted(rid, "chat", p)
        mix.joined(rid)
    snap = mix.snapshot()
    assert snap.counts == (("chat", 8, 2), ("chat", 32, 1))
    key = snap.key
    mix.submitted(3, "chat", 6)
    mix.joined(3)
    assert mix.snapshot().key != key
    key = mix.snapshot().key
    mix.submitted(4, "chat", 8)
    mix.joined(4)
    assert mix.snapshot().key == key
    assert mix.snapshot().decoding == 5


def test_serve_entry_point_on_cpu():
    """``launch/serve.serve`` (test_train_serve_drivers.py:35): generates
    the requested tokens, deterministically from the seed, and a prompt
    longer than 256 tokens takes the flash path (its plain version here)."""
    from repro_torch.launch.serve import serve

    kw = dict(reduced_cfg=True, n_requests=2, prompt_len=260, gen_len=4,
              seed=5, verbose=False, device="cpu")
    a, b = serve("qwen3-0.6b", **kw), serve("qwen3-0.6b", **kw)
    assert tuple(a["tokens"].shape) == (2, 4)
    assert a["output_tokens"] == 8 and a["prefill_calls"] == 1
    assert torch.equal(a["tokens"], b["tokens"])


def test_serve_entry_point_serves_a_given_model_twice():
    """``serve(model=)`` serves the model it is given, twice alike (the
    sessions leave its weights as they were): built from ``serve``'s own
    seed it gives ``serve``'s tokens, from another seed other tokens."""
    from repro_torch.config import default_sharding
    from repro_torch.launch.serve import serve

    cfg = reduced(get_arch("qwen3-0.6b"))
    kw = dict(reduced_cfg=True, n_requests=2, prompt_len=40, gen_len=4,
              seed=5, verbose=False, device="cpu")
    want = serve("qwen3-0.6b", **kw)["tokens"]
    for seed, same in ((5, True), (6, False)):
        model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                            device="cpu").init(seed)
        for _ in range(2):
            got = serve("qwen3-0.6b", model=model, **kw)["tokens"]
            assert torch.equal(got, want) == same


# ----------------------------------------------------------- recurrentgemma
# tests/test_serving.py:95 on the hybrid arch: two remainder-free groups of
# (rglru, rglru, local_attn), window 64.  Its decode state is slot-major
# (RG-LRU state, conv buffer, a circular K/V window per local layer), so
# admission must overwrite a reused slot's rows whole.


@pytest.fixture(scope="module")
def rg_models():
    jmodel = jax_build_model(jax_reduced(jax_get_arch("recurrentgemma-9b")))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    np_params = jax.tree.map(np.asarray, params)
    prefill = jax.jit(jmodel.prefill, static_argnames=("cache_len",
                                                       "cache_dtype"))
    decode = jax.jit(jmodel.decode_step)

    def jax_solo(tokens, max_new, cache_len):
        """The request decoded alone in JAX (batch 1, slab cache)."""
        logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)[None]},
                                cache_len=cache_len, cache_dtype=jnp.float32)
        out = [int(jnp.argmax(logits[0]))]
        for i in range(max_new - 1):
            logits, cache = decode(params, jnp.asarray([out[-1]], jnp.int32),
                                   cache, jnp.asarray(len(tokens) + i))
            out.append(int(jnp.argmax(logits[0])))
        return out

    def port(use_kernels=True):
        model = build_model(reduced(get_arch("recurrentgemma-9b")),
                            ShardingConfig(use_kernels=use_kernels),
                            device="cpu")
        return bridge.load_jax_params(model, np_params)

    return jax_solo, port


def _rg_run(port_model, specs, *, max_slots, cache_len):
    sess = ServingSession(
        ServingConfig(device="cpu", max_slots=max_slots, cache_len=cache_len,
                      page_size=8, cache_dtype="float32"),
        model=port_model,
    )
    sess.run(_port_reqs(specs), max_steps=500)
    return {r: sess.results[r].tokens for r in sess.results}


def _long_specs(seed=9):
    """Prompts and generations past the reduced window (64): one prompt
    longer than it, others that cross it while decoding."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, (p,)).astype(np.int32), g, a)
            for i, (p, g, a) in enumerate([(100, 6, 0.0), (60, 12, 0.0),
                                           (70, 9, 3.0), (58, 10, 5.0)])]


@pytest.mark.parametrize("long", [False, True], ids=["short", "past_window"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_recurrentgemma_continuous_equals_solo_and_jax(rg_models, long,
                                                       use_kernels):
    """Staggered requests in 2 slots (queueing, eviction, slot reuse)
    give each request the tokens it gets alone in the port, and the
    tokens JAX gives it alone."""
    jax_solo, port = rg_models
    specs = _long_specs() if long else _specs(5)
    cache_len = 120 if long else CACHE_LEN
    model = port(use_kernels)
    got = _rg_run(model, specs, max_slots=2, cache_len=cache_len)
    want = {r: jax_solo(t, g, cache_len) for r, t, g, _ in specs}
    assert got == want
    solo = {}
    for spec in specs:
        solo.update(_rg_run(model, [spec[:3] + (0.0,)], max_slots=1,
                            cache_len=cache_len))
    assert got == solo


# ------------------------------------------------- enc-dec and VLM serving
# tests/test_serving.py:41-67's trace on the modal archs: seamless requests
# carry frames of CACHE_LEN // 4, pixtral requests a 16-position stub of
# patch embeddings (which shifts every decode position).  Both sessions
# serve paged with an fp32 cache and replan="off".

MODAL_ARCHS = ("seamless-m4t-medium", "pixtral-12b")


@pytest.fixture(scope="module", params=MODAL_ARCHS)
def modal(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced(jax_get_arch(arch)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5))
    np_params = jax.tree.map(np.asarray, params)
    prefill = jax.jit(jmodel.prefill, static_argnames=("cache_len",
                                                       "cache_dtype"))
    decode = jax.jit(jmodel.decode_step)
    cfg = jmodel.cfg
    rng = np.random.default_rng(13)
    specs = []
    for rid, tokens, g, a in _specs(5):
        shape = ((CACHE_LEN // 4, cfg.d_model) if cfg.is_encdec
                 else (cfg.frontend_stub_len, cfg.d_model))
        key = "frames" if cfg.is_encdec else "embeds"
        specs.append((rid, tokens, g, a,
                      {key: rng.standard_normal(shape).astype(np.float32)}))

    def jax_solo(tokens, extras, max_new):
        """The request decoded alone in JAX (batch 1, slab cache)."""
        batch = {"tokens": jnp.asarray(tokens)[None]}
        batch.update({k: jnp.asarray(v)[None] for k, v in extras.items()})
        logits, cache = prefill(params, batch, cache_len=CACHE_LEN,
                                cache_dtype=jnp.float32)
        total = len(tokens) + (extras["embeds"].shape[0]
                               if "embeds" in extras else 0)
        out = [int(jnp.argmax(logits[0]))]
        for i in range(max_new - 1):
            logits, cache = decode(params, jnp.asarray([out[-1]], jnp.int32),
                                   cache, jnp.asarray(total + i))
            out.append(int(jnp.argmax(logits[0])))
        return out

    solo = {r: jax_solo(t, e, g) for r, t, g, _, e in specs}

    def port():
        model = build_model(reduced(get_arch(arch)),
                            ShardingConfig(use_kernels=True), device="cpu")
        return bridge.load_jax_params(model, np_params)

    return arch, jmodel, params, port, specs, solo


@pytest.mark.parametrize("sharing", [False, True],
                         ids=["plain", "sharing_and_chunks"])
def test_modal_continuous_equals_solo_and_jax(modal, sharing):
    """Two slots force queueing, eviction and slot and page reuse; each
    request's tokens equal JAX's session's and its solo decode, and every
    page counter equals JAX's.  With prefix sharing and a prefill chunk
    asked for, a request with extras never takes a chunk job, never looks
    up the index and is never inserted into it (JAX ``batcher.py:679,
    771, 818, 990``): no chunk steps, hits, maps or forks."""
    arch, jmodel, params, port, specs, solo = modal
    kw = dict(max_slots=2, cache_len=CACHE_LEN, replan="off", page_size=8,
              cache_dtype="float32")
    if sharing:
        kw.update(prefix_sharing=True, prefill_chunk=4)
    jsess = JaxServingSession(JaxServingConfig(kv_layout="paged", **kw),
                              model=jmodel, params=params)
    m_jax = jsess.run([JaxRequest(rid=r, tokens=jnp.asarray(t),
                                  max_new_tokens=g, arrival=a,
                                  extras={k: jnp.asarray(v)
                                          for k, v in e.items()})
                       for r, t, g, a, e in specs], max_steps=500)
    sess = ServingSession(ServingConfig(device="cpu", **kw), model=port())
    m = sess.run([Request(rid=r, tokens=t, max_new_tokens=g, arrival=a,
                          extras=e) for r, t, g, a, e in specs],
                 max_steps=500)
    got = {r: sess.results[r].tokens for r in sess.results}
    assert got == {r: jsess.results[r].tokens for r in jsess.results}
    assert got == solo
    stats = sess.batcher.kv_stats()
    assert stats == {k: m_jax[k] for k in stats}
    for key in ("decode_steps", "prefill_calls", "chunk_steps",
                "output_tokens"):
        assert m[key] == m_jax[key], key
    assert m["chunk_steps"] == 0
    if sharing and arch == "pixtral-12b":  # chunkable: the index exists
        assert stats["prefix_requests"] == stats["prefix_hits"] == 0
        assert stats["kv_shared_maps"] == stats["kv_cow_forks"] == 0
        assert stats["prefix_index_nodes"] == 0


def test_modal_requests_are_validated_like_jax(modal):
    """Frames of another length than the batcher's ``enc_len`` are refused;
    a VLM stub counts toward the cache reach."""
    arch, _, _, port, specs, _ = modal
    sess = ServingSession(ServingConfig(device="cpu", max_slots=2,
                                        cache_len=CACHE_LEN, replan="off",
                                        page_size=8), model=port())
    assert sess.batcher.enc_len == CACHE_LEN // 4
    rid, tokens, _, _, extras = specs[0]
    key, val = next(iter(extras.items()))
    if key == "frames":
        bad = {key: val[:-1]}
        match = "enc_len"
    else:  # 5 prompt + 16 stub + 28 new - 1 = 48 fits; 29 new does not
        bad, match = extras, "cache positions"
        sess.submit(Request(rid=rid, tokens=tokens, max_new_tokens=28,
                            extras=extras))
    with pytest.raises(ValueError, match=match):
        sess.submit(Request(rid=99, tokens=tokens, max_new_tokens=29,
                            extras=bad))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_serve_entry_point_builds_modal_requests(arch):
    """``serve()`` gives enc-dec requests frames of max(prompt // 4, 1) and
    VLM requests min(frontend_stub_len, 8) patch embeddings, which the
    cache length counts (JAX ``launch/serve.py:58-70, 108-118``)."""
    from repro_torch.launch.serve import serve

    out = serve(arch, reduced_cfg=True, n_requests=2, prompt_len=20,
                gen_len=3, seed=1, verbose=False, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 3)
    stub = 8 if arch == "pixtral-12b" else 0
    assert out["kv_slab_tokens"] == 2 * (20 + stub + 3)
    assert out["prefill_calls"] == 1


@pytest.fixture(scope="module")
def glm4_models():
    jmodel = jax_build_model(jax_reduced(jax_get_arch("glm4-9b")))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(6))
    np_params = jax.tree.map(np.asarray, params)

    def port(use_kernels=True):
        model = build_model(reduced(get_arch("glm4-9b")),
                            ShardingConfig(use_kernels=use_kernels),
                            device="cpu")
        return bridge.load_jax_params(model, np_params)

    return jmodel, params, port


@pytest.mark.parametrize("use_kernels", [True, False])
def test_glm4_continuous_equivalence_vs_jax(glm4_models, use_kernels):
    """Reduced glm4-9b (GQA 4:1, as the full model's 32 query heads share
    2 KV heads 16:1) on the staggered trace with a 300-token prompt (the
    flash path): JAX's tokens and page counters."""
    got, want, m, m_jax = _run_both(glm4_models, _specs(5, long_prompt=300),
                                    max_slots=2, cache_len=320,
                                    use_kernels=use_kernels)
    assert len(got) == 6 and got == want
    for key in KV_KEYS + ("decode_steps", "prefill_calls", "output_tokens"):
        assert m[key] == m_jax[key], key


# ------------------------------------------- models with no KV to page
# JAX builds no page pool for a paged layout without a full-attention KV
# leaf (repro/serving/batcher.py:444-466): admission waits on free slots
# only, and kv_stats() holds three keys.  A 3-page pool must not defer such
# a model's requests.


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_kv_less_model_gets_no_page_pool_like_jax(arch):
    jmodel = jax_build_model(jax_reduced(jax_get_arch(arch)))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    model = bridge.load_jax_params(
        build_model(reduced(get_arch(arch)), ShardingConfig(use_kernels=True),
                    device="cpu"),
        jax.tree.map(np.asarray, params))
    specs = _specs(5)
    kw = dict(max_slots=2, cache_len=CACHE_LEN, replan="off", kv_pages=3,
              kv_layout="paged", cache_dtype="float32")
    jsess = JaxServingSession(JaxServingConfig(**kw), model=jmodel,
                              params=params)
    m_jax = jsess.run(_jax_reqs(specs), max_steps=500)
    sess = ServingSession(ServingConfig(device="cpu", **kw), model=model)
    m = sess.run(_port_reqs(specs), max_steps=500)
    got = {r: sess.results[r].tokens for r in sess.results}
    assert len(got) == 5
    assert got == {r: jsess.results[r].tokens for r in jsess.results}
    for key in ("decode_steps", "prefill_calls", "output_tokens"):
        assert m[key] == m_jax[key], key
    b = sess.batcher
    assert b.kv_stats() == jsess.batcher.kv_stats() == {
        "kv_layout": "paged", "kv_slab_tokens": 2 * CACHE_LEN,
        "kv_host_loss_preemptions": 0}
    assert b.pool is None and b.kv_page_bytes == 0
    assert b.can_admit(_port_reqs(specs)[0])
