"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a GPU (the kernels have no CPU mode).
This file imports no JAX, so it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerance:
``|kernel - plain| <= 2e-4 + rtol*|plain|``.  Both sides compute in fp32
from the same inputs and round once to the output dtype, so rtol is 0 in
fp32 (2e-4 covers fp32 accumulation in another order) and 2^-7 in bf16
(one output ulp: at most 2^-7 of the value).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as cuda_gmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as cuda_paged


ATOL = 2e-4


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_close(got, want, rtol):
    diff = (got.float() - want.float()).abs()
    excess = float((diff - rtol * want.float().abs()).max())
    assert excess <= ATOL, (float(diff.max()), excess)


def _paged_inputs(seed, B, H, K, hd, ps, n_pp):
    rng = np.random.default_rng(seed)
    P = B * n_pp + 2
    q = _np(rng, (B, H, hd))
    kp = _np(rng, (P, K, ps, hd))
    vp = _np(rng, (P, K, ps, hd))
    table = (1 + np.arange(B * n_pp).reshape(B, n_pp)[:, ::-1]).astype(np.int32)
    table[0, 1:] = 0  # an all-trash tail
    lengths = np.asarray(
        [(n_pp * ps - 1) if b % 2 else (ps // 2) for b in range(B)], np.int32)
    return q, kp, vp, np.ascontiguousarray(table), lengths


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("S,hd", [(300, 64), (17, 16), (512, 128)])
def test_flash_kernel_matches_ref_on_gpu(cuda_device, dtype, rtol, S, hd):
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_np(rng, (2, 8, S, hd))).to(cuda_device, dtype)
    k = torch.from_numpy(_np(rng, (2, 2, S, hd))).to(cuda_device, dtype)
    v = torch.from_numpy(_np(rng, (2, 2, S, hd))).to(cuda_device, dtype)
    before = ops.launch_counts()["flash_attention"]
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        assert got.dtype == dtype
        _assert_close(got, want, rtol)
    assert ops.launch_counts()["flash_attention"] == before + 2


# sequence lengths around the 64-key tiles and the 64/128-row q tiles of
# the bf16 kernel, every head dim it takes and H/K of 1, 2 and 4 (one or
# two query heads per block)
FLASH_S = (1, 63, 64, 65, 127, 128, 129, 300, 512, 1030)
DTYPES = [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -7)]


def _flash_check(dev, dtype, rtol, q, k, v, causal):
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("S", FLASH_S)
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_kernel_tile_edges_on_gpu(cuda_device, dtype, rtol, S, hd):
    rng = np.random.default_rng(S * 7 + hd)
    for group in (1, 2, 4):
        K = 2
        q = torch.from_numpy(_np(rng, (1, K * group, S, hd)))
        k = torch.from_numpy(_np(rng, (1, K, S, hd)))
        v = torch.from_numpy(_np(rng, (1, K, S, hd)))
        for causal in (True, False):
            _flash_check(cuda_device, dtype, rtol, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("S,hd", [(65, 16), (300, 32), (129, 64),
                                  (512, 128), (1030, 128)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_kernel_strided_views_on_gpu(cuda_device, dtype, rtol, S, hd,
                                           group):
    """The model's layout: (B, S, heads, hd) projections passed as their
    transposes, without a copy."""
    rng = np.random.default_rng(S + hd + group)
    B, K = 2, 2
    H = K * group
    q = torch.from_numpy(_np(rng, (B, S, H, hd))).to(cuda_device, dtype)
    k = torch.from_numpy(_np(rng, (B, S, K, hd))).to(cuda_device, dtype)
    v = torch.from_numpy(_np(rng, (B, S, K, hd))).to(cuda_device, dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    assert not qt.is_contiguous()
    got = ops.flash_attention(qt, kt, vt)
    want = ref.flash_attention_ref(qt.contiguous(), kt.contiguous(),
                                   vt.contiguous())
    _assert_close(got, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("Sq,Sk,hd", [(1, 300, 64), (65, 1030, 128),
                                      (300, 64, 128), (129, 17, 32)])
def test_flash_kernel_unequal_lengths_on_gpu(cuda_device, dtype, rtol, Sq, Sk,
                                             hd):
    """Sq != Sk, non-causal and causal (the mask aligned top-left)."""
    rng = np.random.default_rng(Sq * 3 + Sk)
    q = torch.from_numpy(_np(rng, (2, 4, Sq, hd)))
    k = torch.from_numpy(_np(rng, (2, 2, Sk, hd)))
    v = torch.from_numpy(_np(rng, (2, 2, Sk, hd)))
    for causal in (False, True):
        _flash_check(cuda_device, dtype, rtol, q, k, v, causal)


@pytest.mark.cuda
def test_flash_bf16_rejects_views_tma_cannot_read(cuda_device):
    """bf16 reads q, k and v through TMA: a base off 16 bytes raises in the
    wrapper (no copy, no launch)."""
    base = torch.randn(1, 2, 64, 72, device=cuda_device).to(torch.bfloat16)
    q = base[..., 1:65]  # 2 bytes off the allocation, head dim contiguous
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == before
    q32 = torch.randn(1, 2, 64, 72, device=cuda_device)[..., 1:65]
    got = ops.flash_attention(q32, q32, q32)  # fp32 reads no TMA: no rule
    _assert_close(got, ref.flash_attention_ref(q32, q32, q32), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("B,H,K,hd,ps,n_pp", [(3, 8, 2, 64, 16, 2),
                                              (1, 4, 1, 128, 8, 4)])
def test_paged_kernel_matches_ref_on_gpu(cuda_device, dtype, rtol, B, H, K, hd,
                                         ps, n_pp):
    q, kp, vp, table, lengths = _paged_inputs(8, B, H, K, hd, ps, n_pp)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, table, lengths)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    got = ops.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    _assert_close(got, want, rtol)


# paged decode, split over the pages: (q dtype, kv dtype, rtol) — the
# output is in q's dtype, so one bf16 ulp only where q is bf16
PAGED_DTYPES = [(torch.float32, torch.float32, 0.0),
                (torch.float32, torch.bfloat16, 0.0),
                (torch.bfloat16, torch.float32, 2.0 ** -7),
                (torch.bfloat16, torch.bfloat16, 2.0 ** -7)]


def _split_case(seed, K, rep, hd, ps, n_pp, dev, q_dt, kv_dt, trash_row=True):
    """Rows at positions 0, ps-1, ps, on each side of every split boundary
    and at the last position (all n_pp pages), with distinct scattered
    pages and trash (page 0) past each row's position; with ``trash_row``
    one more row whose every page is the trash page."""
    H = K * rep
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_hg = cuda_paged.head_groups(H, K)
    pos = [0, ps - 1, ps, n_pp * ps - 1]
    for _ in range(2):  # the row count moves the split count: settle it
        B = len(pos) + int(trash_row)
        n_split = cuda_paged.num_splits(B, K, n_pp, sms, n_hg)
        pps = -(-n_pp // n_split)
        bounds = [pps * ps * i + o for i in range(1, n_split) for o in (-1, 0)]
        pos = sorted({p for p in [0, ps - 1, ps, n_pp * ps - 1] + bounds
                      if p < n_pp * ps})
    B = len(pos) + int(trash_row)
    rng = np.random.default_rng(seed)
    P = B * n_pp + 1
    table = (1 + rng.permutation(B * n_pp)).reshape(B, n_pp).astype(np.int32)
    lengths = np.asarray(pos + [ps + 1] * int(trash_row), np.int32)
    for b in range(B):
        table[b, lengths[b] // ps + 1:] = 0
    if trash_row:
        table[-1] = 0
    q = torch.from_numpy(_np(rng, (B, H, hd))).to(dev, q_dt)
    kp = torch.from_numpy(_np(rng, (P, K, ps, hd))).to(dev, kv_dt)
    vp = torch.from_numpy(_np(rng, (P, K, ps, hd))).to(dev, kv_dt)
    return [q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt,rtol", PAGED_DTYPES)
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_kernel_split_edges_on_gpu(cuda_device, q_dt, kv_dt, rtol, rep,
                                         ps, hd):
    """Every position class against the plain version, one launch per
    call, and the same bits on a second run (the splits are merged in a
    fixed order)."""
    args = _split_case(ps + hd + rep, 2, rep, hd, ps, 12, cuda_device, q_dt,
                       kv_dt)
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention(*args)
    again = ops.paged_attention(*args)
    assert ops.launch_counts()["paged_attention"] == before + 2
    assert got.dtype == q_dt and got.shape == args[0].shape
    _assert_close(got, ref.paged_attention_ref(*args), rtol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt,rtol", PAGED_DTYPES)
@pytest.mark.parametrize("B,K,n_pp", [(4, 2, 1),     # one page: one split
                                      (40, 16, 4),   # many blocks: one split
                                      (8, 8, 34),    # qwen3's decode step
                                      (2, 1, 200)])  # few blocks: many splits
def test_paged_kernel_split_counts_on_gpu(cuda_device, q_dt, kv_dt, rtol, B,
                                          K, n_pp):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_split = cuda_paged.num_splits(B, K, n_pp, sms)
    assert (n_split == 1) == (n_pp == 1
                              or B * K >= cuda_paged.BLOCKS_PER_SM * sms)
    q, kp, vp, table, lengths = _paged_inputs(B + n_pp, B, 2 * K, K, 128, 16,
                                              n_pp)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, table, lengths)]
    args[0] = args[0].to(q_dt)
    args[1], args[2] = args[1].to(kv_dt), args[2].to(kv_dt)
    _assert_close(ops.paged_attention(*args), ref.paged_attention_ref(*args),
                  rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt,rtol", PAGED_DTYPES)
def test_paged_kernel_trash_page_never_leaks_on_gpu(cuda_device, q_dt, kv_dt,
                                                    rtol):
    """Page 0 full of NaN and inf: no live position reads it, so the output
    is finite and equals the plain version's on a pool whose page 0 is 0
    (masked positions weigh exactly 0 either way)."""
    args = _split_case(21, 2, 2, 128, 16, 12, cuda_device, q_dt, kv_dt,
                       trash_row=False)
    clean = [a.clone() for a in args]
    for pool in (args[1], args[2]):
        pool[0] = float("nan")
        pool[0, :, ::2] = float("inf")
    for pool in (clean[1], clean[2]):
        pool[0] = 0
    got = ops.paged_attention(*args)
    assert bool(torch.isfinite(got).all())
    _assert_close(got, ref.paged_attention_ref(*clean), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("hd,ps,offset", [(20, 3, 0),    # slab not 16-byte sized
                                          (66, 16, 0),   # rows padded per lane
                                          (17, 5, 0),
                                          (128, 16, 1)])  # pools off 16 bytes
def test_paged_kernel_unaligned_slabs_on_gpu(cuda_device, dtype, rtol, hd, ps,
                                             offset):
    """Slabs that bulk copies cannot take are copied by the producer warp's
    lanes: same results."""
    q, kp, vp, table, lengths = _paged_inputs(30 + hd, 3, 4, 2, hd, ps, 5)
    args = [torch.from_numpy(a).to(cuda_device) for a in
            (q, kp, vp, table, lengths)]
    args[0] = args[0].to(dtype)
    for i in (1, 2):
        pool = args[i].to(dtype)
        if offset:
            buf = torch.empty(pool.numel() + offset, dtype=dtype,
                              device=cuda_device)
            buf[offset:] = pool.reshape(-1)
            pool = buf[offset:].view(pool.shape)
        args[i] = pool
    _assert_close(ops.paged_attention(*args), ref.paged_attention_ref(*args),
                  rtol)


@pytest.mark.cuda
def test_paged_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 2, 264, device=cuda_device)
    pool = torch.zeros(3, 1, 4, 264, device=cuda_device)
    table = torch.ones(1, 2, dtype=torch.int32, device=cuda_device)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = ops.launch_counts()["paged_attention"]
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q, pool, pool, table, pos)
    assert ops.launch_counts()["paged_attention"] == before


@pytest.mark.cuda
def test_decode_kernels_replay_in_a_cuda_graph(cuda_device):
    """Paged decode (split, with its workspace and counters) and the skinny
    grouped matmul read no device value on the host, so a CUDA graph
    captures them; a replay on new inputs gives the eager results."""
    paged_args = _split_case(40, 8, 2, 128, 16, 34, cuda_device,
                             torch.bfloat16, torch.bfloat16)
    assert cuda_paged.num_splits(
        paged_args[0].shape[0], 8, 34,
        torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ) > 1
    rng = np.random.default_rng(41)
    x = torch.from_numpy(_np(rng, (8, 4, 256))).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(_np(rng, (8, 256, 136)) / 16).to(cuda_device,
                                                          torch.bfloat16)
    gs = torch.tensor([0, 1, 2, 3, 4, 4, 1, 0], dtype=torch.int32,
                      device=cuda_device)
    ops.paged_attention(*paged_args)  # warm: build, plan and counters
    ops.grouped_matmul(x, w, gs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_p = ops.paged_attention(*paged_args)
        out_g = ops.grouped_matmul(x, w, gs)
    for t in paged_args[:3] + [x, w]:
        t.copy_(torch.randn_like(t.float()).to(t.dtype))
    gs.copy_(torch.tensor([4, 0, 3, 1, 2, 4, 0, 2], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out_p, ops.paged_attention(*paged_args))
    assert torch.equal(out_g, ops.grouped_matmul(x, w, gs))
    _assert_close(out_p, ref.paged_attention_ref(*paged_args), 2.0 ** -7)
    _assert_close(out_g, ref.grouped_matmul_ref(x, w, gs), 2.0 ** -7)


@pytest.mark.cuda
def test_paged_counters_survive_a_large_call_under_a_captured_graph(
        cuda_device):
    """A graph captured with one stream's split counters replays right
    after a call on that stream with more (row, KV head) pairs than the
    counters hold (B 128, K 16: too many blocks to split) and after fresh
    blocks of the counters' size were handed out: the counter tensor is
    the one the graph captured, still alive."""
    stream = torch.cuda.Stream(cuda_device)
    small = _split_case(50, 8, 2, 128, 16, 34, cuda_device, torch.bfloat16,
                        torch.bfloat16)
    with torch.cuda.stream(stream):
        ops.paged_attention(*small)  # warm: build, plan and counters
    stream.synchronize()
    key = (cuda_device.index or 0, stream.cuda_stream)
    counters = cuda_paged._COUNTERS[key][0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.paged_attention(*small)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rng = np.random.default_rng(51)
    B, K, ps, n_pp = 128, 16, 16, 4
    assert B * K > counters.numel()
    big = [torch.from_numpy(_np(rng, shape)).to(cuda_device, torch.bfloat16)
           for shape in ((B, K, 128), (B * n_pp + 1, K, ps, 128),
                         (B * n_pp + 1, K, ps, 128))]
    big += [torch.arange(1, B * n_pp + 1, dtype=torch.int32,
                         device=cuda_device).reshape(B, n_pp),
            torch.full((B,), n_pp * ps - 1, dtype=torch.int32,
                       device=cuda_device)]
    assert cuda_paged.num_splits(B, K, n_pp, sms) == 1
    with torch.cuda.stream(stream):
        got_big = ops.paged_attention(*big)
        junk = [torch.full((counters.numel(),), 7, dtype=torch.int32,
                           device=cuda_device) for _ in range(64)]
    stream.synchronize()
    _assert_close(got_big, ref.paged_attention_ref(*big), 2.0 ** -7)
    assert cuda_paged._COUNTERS[key][0] is counters
    for t in small[:3]:
        t.copy_(torch.randn_like(t.float()).to(t.dtype))
    with torch.cuda.stream(stream):
        graph.replay()
    stream.synchronize()
    _assert_close(out, ref.paged_attention_ref(*small), 2.0 ** -7)
    assert all(int(j.min()) == 7 for j in junk)
    assert int(counters.abs().max()) == 0


@pytest.mark.cuda
def test_paged_graphs_captured_before_any_eager_launch_replay_in_any_order(
        cuda_device, monkeypatch):
    """Two graphs captured on a stream that never ran a launch outside a
    capture, so its split counters are made inside the first capture:
    each graph zeroes them at its start, so the second one replayed first,
    over counters full of garbage, gives the plain version's output, and
    both leave the counters at zero."""
    monkeypatch.setattr(cuda_paged, "_COUNTERS", {})
    cases = [_split_case(70 + i, 8, 2, 128, 16, 34, cuda_device,
                         torch.bfloat16, torch.bfloat16) for i in range(2)]
    ops.paged_attention(*cases[0])  # build and plan on another stream
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(cuda_device)
    key = (cuda_device.index or 0, stream.cuda_stream)
    assert key not in cuda_paged._COUNTERS
    graphs, outs = [], []
    for args in cases:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1], stream=stream):
            outs.append(ops.paged_attention(*args))
    counters, zeroed = cuda_paged._COUNTERS[key]
    assert not zeroed
    with torch.cuda.stream(stream):
        counters.fill_(7)  # memory nobody wrote
        graphs[1].replay()
        graphs[0].replay()
    stream.synchronize()
    for args, out in zip(cases, outs):
        _assert_close(out, ref.paged_attention_ref(*args), 2.0 ** -7)
    assert int(counters.abs().max()) == 0


@pytest.mark.cuda
def test_paged_split_calls_on_two_streams_at_once(cuda_device):
    """Split decode calls of one shape enqueued on two streams at once,
    each many times over: every output is the plain version's (each stream
    has its own counters, so neither merges the other's splits)."""
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    cases = [_split_case(60 + i, 8, 2, 128, 16, 34, cuda_device,
                         torch.bfloat16, torch.bfloat16) for i in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(ops.paged_attention(*args))
    torch.cuda.synchronize()
    for args, got in zip(cases, outs):
        want = ref.paged_attention_ref(*args)
        for o in got:
            _assert_close(o, want, 2.0 ** -7)
            assert torch.equal(o, got[0])


@pytest.mark.cuda
def test_dense_decode_step_launches_paged_without_host_sync(cuda_device):
    """A reduced qwen3 decode step over a random paged fp32 cache with
    kernels on: no host sync (``set_sync_debug_mode("error")`` raises on
    one), one paged launch per layer, and the CPU's plain path's logits."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_arch("qwen3-0.6b"))
    sh = ShardingConfig(use_kernels=True)
    cpu = build_model(cfg, sh, device="cpu").init(5)
    gpu = build_model(cfg, sh, device="cuda")
    gpu.load_state(dict(cpu.impl.named_parameters()))
    g = torch.Generator().manual_seed(8)

    def make(model, dev):
        cache, _ = model.init_paged_cache(2, 64, n_pages=17, page_size=8,
                                          cache_dtype=torch.float32)
        g.manual_seed(8)
        for st in cache:
            for v in st.values():
                v.copy_(torch.randn(v.shape, generator=g).to(dev))
        return cache

    table = torch.arange(1, 17, dtype=torch.int32).reshape(2, 8)
    table[0, 2:] = 0
    pos = torch.tensor([13, 40], dtype=torch.int32)
    tok = torch.tensor([3, 7])
    want, _ = cpu.decode_step(tok, make(cpu, "cpu"), pos, pages=table)
    cache = make(gpu, cuda_device)
    args = [t.to(cuda_device) for t in (tok, pos, table)]
    torch.cuda.synchronize()
    before = ops.launch_counts()["paged_attention"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = gpu.decode_step(args[0], cache, args[1], pages=args[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["paged_attention"] == before + cfg.n_layers
    _assert_close(got.cpu(), want, 0.0)


@pytest.mark.cuda
def test_paged_scatter_drops_stale_rows_on_gpu(cuda_device):
    """The stale-slot write rule (a position past the page table goes to
    the trash page, no out-of-range index) gives the same mapped pages on
    the card as on the CPU."""
    from repro_torch.models.attention import page_slots, paged_scatter

    rng = np.random.default_rng(9)
    pool = _np(rng, (14, 2, 4, 16))
    table = np.asarray([[5, 2, 9], [1, 7, 0], [0, 0, 0], [3, 11, 4]], np.int32)
    pos = np.asarray([9, 4, 6, 12], np.int32)
    vals = _np(rng, (4, 2, 16))

    def scatter(dev):
        t = [torch.from_numpy(a).to(dev) for a in (pool.copy(), table, pos,
                                                    vals)]
        return paged_scatter(t[0], page_slots(t[1], t[2], 4), t[3]).cpu()

    want, got = scatter("cpu"), scatter(cuda_device)
    assert torch.equal(got[1:], want[1:])
    assert not torch.equal(want[1:], torch.from_numpy(pool)[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("E,C,d,f,sizes", [
    (4, 64, 96, 80, [64, 33, 0, 1]),        # tests/test_kernels.py:130
    (4, 130, 160, 200, [130, 65, 64, 7]),   # ragged against the 64 tiles
    (3, 4, 2048, 1408, [4, 0, 2]),          # a decode-shaped call
    (2, 16, 36, 44, None),                  # d, f not multiples of 8
])
def test_gmm_kernel_matches_ref_on_gpu(cuda_device, dtype, rtol, E, C, d, f,
                                       sizes):
    rng = np.random.default_rng(10 + C)
    x = torch.from_numpy(_np(rng, (E, C, d))).to(cuda_device, dtype)
    w = (torch.from_numpy(_np(rng, (E, d, f))) / d ** 0.5).to(cuda_device, dtype)
    gs = None if sizes is None else torch.tensor(sizes, dtype=torch.int32,
                                                 device=cuda_device)
    before = ops.launch_counts()["grouped_matmul"]
    got = ops.grouped_matmul(x, w, gs)
    want = ref.grouped_matmul_ref(x, w, gs)
    assert ops.launch_counts()["grouped_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (E, C, f)
    _assert_close(got, want, rtol)
    for e, n in enumerate(sizes or []):  # rows past the group: exactly 0
        assert not got[e, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
def test_gmm_kernel_prefill_shape_on_gpu(cuda_device, dtype, rtol):
    """qwen2-moe's prefill shape cut to 4 experts (C 341, d 2048, f 1408),
    with an empty group, a single row, a partial tile and a full one: bf16
    takes the wgmma variant; rows past each group are exactly 0."""
    E, C, d, f = 4, 341, 2048, 1408
    sizes = [0, 1, 37, 341]
    rng = np.random.default_rng(16)
    x = torch.from_numpy(_np(rng, (E, C, d))).to(cuda_device, dtype)
    w = (torch.from_numpy(_np(rng, (E, d, f))) / d ** 0.5).to(cuda_device, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
    assert cuda_gmm.variant(x, w) == ("wgmma" if dtype == torch.bfloat16
                                      else "fp32")
    got = ops.grouped_matmul(x, w, gs)
    _assert_close(got, ref.grouped_matmul_ref(x, w, gs), rtol)
    for e, n in enumerate(sizes):
        assert not got[e, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("C", [1, 2, 4, 8, cuda_gmm.SKINNY_MAX_ROWS])
@pytest.mark.parametrize("d,f", [(2048, 1408),   # decode gate/up
                                 (1408, 2048),   # decode down
                                 (200, 200),     # f past a 128-column tile,
                                                 # d past a 128-row chunk
                                 (8, 8)])
def test_gmm_skinny_kernel_on_gpu(cuda_device, dtype, rtol, C, d, f):
    """The skinny variant (C <= 16) with empty, partial and full groups:
    within tolerance of the plain version, rows past each group exactly
    0, one launch per call."""
    E = 4
    sizes = [0, max(C // 2, 1), C, C]
    rng = np.random.default_rng(C * 31 + d)
    x = torch.from_numpy(_np(rng, (E, C, d))).to(cuda_device, dtype)
    w = (torch.from_numpy(_np(rng, (E, d, f))) / d ** 0.5).to(cuda_device,
                                                           dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
    assert cuda_gmm.variant(x, w) == "skinny"
    before = ops.launch_counts()["grouped_matmul"]
    got = ops.grouped_matmul(x, w, gs)
    assert ops.launch_counts()["grouped_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (E, C, f)
    _assert_close(got, ref.grouped_matmul_ref(x, w, gs), rtol)
    for e, n in enumerate(sizes):
        assert not got[e, n:].any()
    full = ops.grouped_matmul(x, w)  # no sizes: every group full
    _assert_close(full, ref.grouped_matmul_ref(x, w), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("C,d,f,offset,want", [
    (64, 96, 80, 0, "wgmma"),
    (63, 96, 80, 0, "wmma"),     # fewer rows than one warpgroup's 64
    (4, 2048, 1408, 0, "skinny"),  # the decode step
    (64, 36, 80, 0, "wmma"),     # d not a multiple of 8
    (64, 96, 80, 1, "wmma"),     # x 2 bytes off 16
])
def test_gmm_variant_rule_on_gpu(cuda_device, C, d, f, offset, want):
    """The variant the shape rule names is the one that runs, and each is
    right (bf16)."""
    rng = np.random.default_rng(C + d + offset)
    flat = torch.from_numpy(_np(rng, (2 * C * d + offset,)))
    x = flat[offset:].reshape(2, C, d).to(cuda_device, torch.bfloat16)
    if offset:  # the same misalignment on the card
        buf = torch.empty(2 * C * d + offset, device=cuda_device,
                          dtype=torch.bfloat16)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(2, C, d)
    w = (torch.from_numpy(_np(rng, (2, d, f))) / d ** 0.5).to(cuda_device,
                                                           torch.bfloat16)
    gs = torch.tensor([C, C // 2], dtype=torch.int32, device=cuda_device)
    assert cuda_gmm.variant(x, w) == want
    got = ops.grouped_matmul(x, w, gs)
    _assert_close(got, ref.grouped_matmul_ref(x, w, gs), 2.0 ** -7)
    assert not got[1, C // 2:].any()


@pytest.mark.cuda
def test_moe_layer_launches_gmm_without_host_sync(cuda_device):
    """The MoE layer with kernels on routes, dispatches and combines on
    the device — no host sync (``set_sync_debug_mode("error")`` raises on
    one) — launches the grouped matmul 3 times, and matches the CPU's plain
    path in fp32."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.models.moe import moe_apply

    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(12)
    p = {"router": _np(rng, (d, m.n_experts)) / d ** 0.5,
         "we_gate": _np(rng, (m.n_experts, d, 64)) / d ** 0.5,
         "we_up": _np(rng, (m.n_experts, d, 64)) / d ** 0.5,
         "we_down": _np(rng, (m.n_experts, 64, d)) / 8.0,
         "shared": {k: _np(rng, s) / s[0] ** 0.5 for k, s in
                    (("w_gate", (d, 64)), ("w_up", (d, 64)),
                     ("w_down", (64, d)))}}
    x = _np(rng, (4, 33, d))

    def tree(dev):
        return {k: ({kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(v).to(dev))
                for k, v in p.items()}

    want, _ = moe_apply(tree("cpu"), torch.from_numpy(x), cfg, use_kernels=True)
    params, xg = tree(cuda_device), torch.from_numpy(x).to(cuda_device)
    torch.cuda.synchronize()
    before = ops.launch_counts()["grouped_matmul"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = moe_apply(params, xg, cfg, use_kernels=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["grouped_matmul"] == before + 3
    _assert_close(got.cpu(), want, 0.0)


# ---------------------------------------------------------------- RG-LRU scan
# the shapes of chip_smoke.py's phase 3: recurrentgemma-9b's prefill
# (8 x 512 tokens, d 4096), a ragged one, and a long decay; fp32 within
# tests/test_kernels.py's 1e-4 (1e-3 for the long decay), bf16 within one
# output ulp


def _scan_inputs(B, S, D, decay=None, seed=13):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if decay is None:
        a = torch.sigmoid(torch.randn(B, S, D, generator=g))
        b = torch.randn(B, S, D, generator=g)
    else:
        a = torch.full((B, S, D), decay)
        b = torch.full((B, S, D), 0.01)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("B,S,D,decay,atol", [
    (8, 512, 4096, None, 1e-4),
    (3, 300, 130, None, 1e-4),
    (1, 2048, 4096, 0.999, 1e-3),
])
def test_rglru_scan_kernel_matches_ref_on_gpu(cuda_device, dtype, rtol, B, S,
                                              D, decay, atol):
    a, b = (t.to(cuda_device, dtype) for t in _scan_inputs(B, S, D, decay))
    before = ops.launch_counts()["rglru_scan"]
    got = ops.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    assert ops.launch_counts()["rglru_scan"] == before + 1
    assert got.dtype == dtype and got.shape == (B, S, D)
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()
    assert float((diff - rtol * want.float().abs()).max()) <= atol


# every shape chip_smoke.py's phase 3 checks the scan at: recurrentgemma-9b's
# 8 x 512 prefill, a ragged D (plain loads, not bulk copies), a long decay,
# and 8g's (data 2, model 2) rank's features in a train row and a prompt
SCAN_CHIP_SHAPES = [(8, 512, 4096, None), (3, 300, 130, None),
                    (1, 2048, 4096, 0.999), (2, 1024, 2048, None),
                    (2, 2100, 2048, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,decay", SCAN_CHIP_SHAPES)
def test_rglru_scan_fp32_equals_plain_bit_for_bit_on_gpu(cuda_device, B, S,
                                                         D, decay):
    """The fp32 kernel repeats the plain version's arithmetic (fp32 carry,
    multiply and add rounded apart, sequential in t): the same bits."""
    a, b = (t.to(cuda_device) for t in _scan_inputs(B, S, D, decay, seed=S))
    assert torch.equal(ops.rglru_scan(a, b), ref.rglru_scan_ref(a, b))


def _flipped_scan_backward(a, h, g):
    """The scan's gradient as the port computed it before the reverse
    launch: the forward kernel on flipped, shifted copies, then the
    elementwise products."""
    from repro_torch.kernels import rglru_scan as cuda_scan

    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    dh = cuda_scan.rglru_scan(a_next.flip(1).contiguous(),
                              g.flip(1).contiguous()).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return dh * h_prev, dh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [(4, 1024, 4096),   # phase 6f's layer
                                   (2, 1024, 2048),   # 8g's rank
                                   (3, 300, 130)])    # ragged: plain loads
def test_rglru_scan_reverse_launch_equals_flipped_scans_on_gpu(
        cuda_device, dtype, B, S, D):
    """The gradient is one launch of the kernel run backwards in time,
    keyed ``reverse``, reading a, g and h in place; it equals the flipped
    copies through the forward kernel and the products bit for bit."""
    a, b = (t.to(cuda_device, dtype) for t in _scan_inputs(B, S, D, seed=3))
    g = torch.randn(B, S, D, generator=torch.Generator().manual_seed(4)).to(
        cuda_device, dtype)
    h = ops.rglru_scan(a, b)
    ops.reset_launch_counts()
    got = ops.rglru_scan_backward(a, h, g)
    assert ops.launch_keys()["rglru_scan"] == {
        (B, S, D, str(dtype).removeprefix("torch."), True): 1}
    want = _flipped_scan_backward(a, h, g)
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.is_contiguous()
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_hybrid_prefill_and_decode_without_host_sync(cuda_device):
    """Reduced recurrentgemma in fp32 with kernels on: a 100-token prefill
    (past the 64-token window: the roll) and a decode step into the
    circular buffers, with no host sync (``set_sync_debug_mode("error")``
    raises on one); the scan runs once per rglru layer, and both calls
    match the CPU's plain path."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_arch("recurrentgemma-9b"))
    sh = ShardingConfig(use_kernels=True)
    cpu = build_model(cfg, sh, device="cpu").init(5)
    gpu = build_model(cfg, sh, device="cuda")
    gpu.load_state(dict(cpu.impl.named_parameters()))
    toks = torch.randint(0, cfg.vocab, (2, 100),
                         generator=torch.Generator().manual_seed(6))
    pos = torch.full((2,), 100, dtype=torch.int32)

    def run(model, toks, pos):
        logits, cache = model.prefill({"tokens": toks}, cache_len=120,
                                      cache_dtype=torch.float32)
        tok = logits.argmax(dim=-1)
        step, _ = model.decode_step(tok, cache, pos)
        return logits, step

    want = run(cpu, toks, pos)
    toks, pos = toks.to(cuda_device), pos.to(cuda_device)
    torch.cuda.synchronize()
    before = ops.launch_counts()["rglru_scan"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(gpu, toks, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["rglru_scan"] == before + 4
    for g, w in zip(got, want):
        _assert_close(g.cpu(), w, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt,rtol", [
    (torch.float32, torch.float32, 0.0),
    (torch.bfloat16, torch.bfloat16, 2.0 ** -7),
])
def test_paged_kernel_all_trash_row_at_the_cache_end_on_gpu(cuda_device, q_dt,
                                                           kv_dt, rtol):
    """A paused or prefilling slot in a chunked serving step: its table row
    is all zeros (every page the trash page 0) and its position the last of
    the cache, beside live rows.  The kernel reads that row's whole reach
    through page 0 without a fault, and the live rows equal the plain
    version."""
    B, H, K, hd, ps, n_pp = 4, 16, 8, 128, 16, 100
    q, kp, vp, table, _ = _paged_inputs(21, B, H, K, hd, ps, n_pp)
    table[0] = 0
    table[2] = 0
    lengths = np.asarray([n_pp * ps - 1, 1535, n_pp * ps - 1, 700], np.int32)
    table[3, 700 // ps + 1:] = 0
    args = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, table,
                                                           lengths)]
    args[0] = args[0].to(q_dt)
    args[1], args[2] = args[1].to(kv_dt), args[2].to(kv_dt)
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    assert ops.launch_counts()["paged_attention"] == before + 1
    assert bool(torch.isfinite(got).all())
    live = [1, 3]
    _assert_close(got[live], want[live], rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("C,dtype,rtol,variant", [
    (21, torch.float32, 0.0, "fp32"),
    (21, torch.bfloat16, 2.0 ** -7, "wmma"),
    (170, torch.float32, 0.0, "fp32"),
    (170, torch.bfloat16, 2.0 ** -7, "wgmma"),
])
def test_gmm_kernel_chunk_capacity_on_gpu(cuda_device, C, dtype, rtol,
                                          variant):
    """A chunked MoE prefill's expert products: one row x 256 tokens gives
    qwen2-moe a capacity of 21 (16 < C < 64: bf16 takes the wmma variant),
    8 rows x 256 tokens one of 170 (bf16: wgmma); E 64, d 2048, f 1408,
    with an empty group, a single row, a partial group, a full one and
    dead experts."""
    E, d, f = 64, 2048, 1408
    rng = np.random.default_rng(22)
    sizes = np.minimum(rng.integers(0, 2 * C, E), C)
    sizes[:4] = [0, 1, C - 1, C]
    sizes[60:] = 0
    x = torch.from_numpy(_np(rng, (E, C, d))).to(cuda_device, dtype)
    w = (torch.from_numpy(_np(rng, (E, d, f))) / d ** 0.5).to(cuda_device, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
    assert cuda_gmm.variant(x, w) == variant
    got = ops.grouped_matmul(x, w, gs)
    want = ref.grouped_matmul_ref(x, w, gs)
    _assert_close(got, want, rtol)
    for e, n in enumerate(sizes):  # rows past the group: exactly 0
        assert not got[e, n:].any()


@pytest.mark.cuda
def test_chunked_shared_grow_serving_equal_on_cuda_and_cpu(cuda_device):
    """Reduced qwen3 in fp32 with 8-token chunks, prefix sharing and grow
    admission in a pool small enough to preempt: a shared-prefix burst
    gives the same tokens and the same page accounting on the card (the
    kernels) as on the CPU (their plain versions)."""
    from repro_torch.serving import Request, ServingConfig, ServingSession

    rng = np.random.default_rng(23)
    prefix = rng.integers(0, 256, (20,))
    trace = [(i, np.concatenate([prefix, rng.integers(0, 256, (4,))]))
             for i in range(5)]
    keys = ("chunk_steps", "interleaved_chunks", "decode_steps",
            "kv_cow_forks", "kv_shared_maps", "kv_grow_allocs",
            "kv_preemptions", "kv_page_hw")
    out = {}
    for dev in ("cuda", "cpu"):
        sess = ServingSession(ServingConfig(
            device=dev, seed=3, max_slots=4, cache_len=40, page_size=8,
            prefill_chunk=8, prefix_sharing=True, kv_admission="grow",
            kv_pages=10, cache_dtype="float32", replan="off"))
        m = sess.run([Request(rid=r, tokens=t, max_new_tokens=12,
                              arrival=float(r // 2)) for r, t in trace],
                     max_steps=1000)
        out[dev] = ({r: res.tokens for r, res in sess.results.items()},
                    {k: m[k] for k in keys})
    assert len(out["cpu"][0]) == 5 and out["cpu"][1]["kv_cow_forks"] > 0
    assert out["cuda"] == out["cpu"]


# the flash autograd function: the forward kernel, the backward kernel
# (the training path).  Tolerance of a gradient, relative to its largest
# entry, against the plain backward in fp32 on the same inputs: fp32 1e-5
# (sums in another order); bf16 twice SDPA's own bf16 backward error
# against the same reference on the same inputs (P and dS are rounded to
# bf16 for their products there too, and every gradient once on output)
def _exact_flash_grads(q, k, v, g, causal):
    """(dq, dk, dv) of the plain version in fp32 from ``q, k, v, g``."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    o, lse = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                     return_lse=True)
    return ref.flash_attention_backward_ref(qf, kf, vf, o, lse, gf,
                                            causal=causal)


def _rel_errs(got, want):
    return [float((a.float() - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]


def _sdpa_rel_errs(q, k, v, g, causal, want):
    """SDPA's forward + backward on the same inputs (KV heads repeated as
    leaves, their gradients summed in fp32), relative errors against
    ``want``."""
    import torch.nn.functional as F

    G = q.shape[1] // k.shape[1]
    ins = [q.detach().requires_grad_()] + [
        t.repeat_interleave(G, 1).detach().requires_grad_() for t in (k, v)]
    out = F.scaled_dot_product_attention(*ins, is_causal=causal)
    dq, dk, dv = torch.autograd.grad(out, ins, g)
    B, _, Sk, hd = k.shape
    dk, dv = (t.float().reshape(B, -1, G, Sk, hd).sum(2) for t in (dk, dv))
    return _rel_errs((dq, dk, dv), want)


def _assert_flash_grads(got, q, k, v, g, causal):
    want = _exact_flash_grads(q, k, v, g, causal)
    errs = _rel_errs(got, want)
    if q.dtype == torch.float32:
        assert max(errs) <= 1e-5, errs
    else:
        sdpa = _sdpa_rel_errs(q, k, v, g, causal, want)
        assert all(e <= 2 * s for e, s in zip(errs, sdpa)), (errs, sdpa)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("H,K,S,hd", [(8, 2, 300, 64), (16, 8, 1024, 128)])
def test_flash_backward_matches_plain_on_gpu(cuda_device, dtype, rtol, H, K,
                                             S, hd, monkeypatch):
    """Gradients through ``ops.flash_attention`` for head-major views of
    (B, S, heads, hd) projections, as the model passes them: the forward
    launches the flash kernel once, the backward the backward kernel once
    and never the plain forward (monkeypatched to raise); the gradients
    hold the stated tolerance against the plain backward in fp32."""
    rng = np.random.default_rng(41)
    B = 2

    def view(n):  # (B, S, n, hd) storage seen head-major, as attn_apply does
        x = torch.from_numpy(_np(rng, (B, S, n, hd))).to(cuda_device, dtype)
        return x.transpose(1, 2)

    q, k, v = view(H), view(K), view(K)
    g = torch.from_numpy(_np(rng, (B, H, S, hd))).to(cuda_device, dtype)
    before = ops.launch_counts()
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*ins)
    real = ref.flash_attention_ref

    def forbidden(*a, **kw):
        raise AssertionError("the backward recomputed the plain forward")

    monkeypatch.setattr(ref, "flash_attention_ref", forbidden)
    got = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    monkeypatch.setattr(ref, "flash_attention_ref", real)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert (after["flash_attention_backward"]
            == before["flash_attention_backward"] + 1)
    _assert_close(out.detach(), ref.flash_attention_ref(q, k, v), rtol)
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
    _assert_flash_grads(got, q, k, v, g, True)


# every shape the chip phases' training paths launch the backward at, and
# the rest of what the forward takes: ragged S, H/K of 1 to 16, every head
# dim, Sq != Sk non-causal
FLASH_BWD_CASES = [  # (B, H, K, Sq, Sk, hd, causal)
    (8, 16, 8, 1024, 1024, 128, True),  # phase 6: qwen3-0.6b, 8 x 1,024
    (4, 16, 8, 1024, 1024, 128, True),  # 8b's data-parallel rank
    (4, 8, 4, 1024, 1024, 128, True),   # 8e / 8h: a (data 2, model 2) rank
    (4, 16, 16, 1024, 1024, 128, True),  # 6e: qwen2-moe, 4 x 1,024
    (2, 8, 8, 320, 320, 64, False),     # 8g: seamless encoder
    (2, 8, 8, 1280, 1280, 64, True),    # 8g: decoder self
    (2, 8, 8, 1280, 320, 64, False),    # 8g: cross attention
    (2, 8, 2, 1040, 1040, 128, True),   # ragged S, H/K 4
    (1, 32, 2, 300, 300, 128, True),    # glm4's H/K 16
    (2, 4, 2, 65, 65, 16, True),        # one key past a tile
    (3, 4, 4, 17, 17, 32, False),       # fewer rows than a tile
    (2, 4, 1, 129, 40, 64, False),      # Sq > Sk non-causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("strided", [False, True])
def test_flash_backward_kernel_at_the_chip_shapes_on_gpu(cuda_device, dtype,
                                                         case, strided):
    """The backward kernel against the plain backward in fp32, fed the
    forward kernel's output and log-sum-exp; q, k and v contiguous or
    head-major views of (B, S, heads, hd)."""
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import flash_attention_bwd as bwd_k

    B, H, K, Sq, Sk, hd, causal = case
    rng = np.random.default_rng(sum(case[:6]))

    def make(n, S):
        x = torch.from_numpy(_np(rng, (B, S, n, hd))).to(cuda_device, dtype)
        return x.transpose(1, 2) if strided else x.transpose(1, 2).contiguous()

    q, k, v = make(H, Sq), make(K, Sk), make(K, Sk)
    g = torch.from_numpy(_np(rng, (B, H, Sq, hd))).to(cuda_device, dtype)
    o, lse = flash_k.flash_attention(q, k, v, causal=causal, return_lse=True)
    want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=True)[1]
    assert float((lse - want_lse).abs().max()) <= 1e-4
    got = bwd_k.flash_attention_backward(q, k, v, o, lse, g, causal=causal)
    torch.cuda.synchronize()
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
    _assert_flash_grads(got, q, k, v, g, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_repeats_bit_for_bit_on_gpu(cuda_device, dtype):
    """No atomics: two calls on the same inputs give the same bits (the
    card's replica and SP-against-TP checks rely on it)."""
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import flash_attention_bwd as bwd_k

    rng = np.random.default_rng(47)
    B, H, K, S, hd = 4, 16, 8, 1024, 128
    q = torch.from_numpy(_np(rng, (B, H, S, hd))).to(cuda_device, dtype)
    k, v = (torch.from_numpy(_np(rng, (B, K, S, hd))).to(cuda_device, dtype)
            for _ in range(2))
    g = torch.from_numpy(_np(rng, (B, H, S, hd))).to(cuda_device, dtype)
    o, lse = flash_k.flash_attention(q, k, v, return_lse=True)
    first = bwd_k.flash_attention_backward(q, k, v, o, lse, g)
    second = bwd_k.flash_attention_backward(q, k, v, o, lse, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_repeats_at_the_chip_shapes_on_gpu(cuda_device, case):
    """Two bf16 calls give the same bits at every shape the backward is
    checked at: no sum depends on which block finishes first."""
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import flash_attention_bwd as bwd_k

    B, H, K, Sq, Sk, hd, causal = case
    rng = np.random.default_rng(sum(case[:6]) + 1)
    dt = torch.bfloat16
    q = torch.from_numpy(_np(rng, (B, H, Sq, hd))).to(cuda_device, dt)
    k, v = (torch.from_numpy(_np(rng, (B, K, Sk, hd))).to(cuda_device, dt)
            for _ in range(2))
    g = torch.from_numpy(_np(rng, (B, H, Sq, hd))).to(cuda_device, dt)
    o, lse = flash_k.flash_attention(q, k, v, causal=causal, return_lse=True)
    first = bwd_k.flash_attention_backward(q, k, v, o, lse, g, causal=causal)
    second = bwd_k.flash_attention_backward(q, k, v, o, lse, g, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_serving_forward_writes_no_lse_on_gpu(cuda_device):
    """With no input that needs a gradient (serving, prefill) the forward
    asks the kernel for no log-sum-exp: the same output, and no backward
    state kept."""
    rng = np.random.default_rng(48)
    q = torch.from_numpy(_np(rng, (2, 8, 300, 64))).to(cuda_device,
                                                       torch.bfloat16)
    kv = torch.from_numpy(_np(rng, (2, 4, 300, 64))).to(cuda_device,
                                                        torch.bfloat16)
    with torch.no_grad():
        served = ops.flash_attention(q, kv, kv)
    trained = ops.flash_attention(q.requires_grad_(), kv, kv)
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_step_launches_flash_twice_per_layer_on_gpu(cuda_device,
                                                          compute):
    """One loss + backward of a reduced qwen3 training model at S 320 under
    block remat launches flash 2 x n_layers times (forward and recompute),
    the flash backward once a layer and no other kernel; in fp32 its loss
    and gradients equal the CPU model's (the plain path) within 1e-4."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_arch("qwen3-0.6b"), compute_dtype=compute,
                  head_dim=128 if compute == "bfloat16" else 16)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 256,
                                                              (2, 321)))
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, ShardingConfig(use_kernels=True), device=dev,
                        train=True)
        m.init(0)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        before = ops.launch_counts()
        loss, _ = m.loss(batch)
        grads = torch.autograd.grad(loss, list(m.impl.parameters()))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        delta = {n: after[n] - before[n] for n in after}
        L = cfg.n_layers if dev == "cuda" else 0
        assert delta == {**{n: 0 for n in after}, "flash_attention": 2 * L,
                         "flash_attention_backward": L}
        assert torch.isfinite(loss)
        out[dev] = (float(loss), [g.float().cpu() for g in grads])
    if compute == "float32":
        assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-4
        for a, b in zip(out["cuda"][1], out["cpu"][1]):
            assert float((a - b).abs().max()) < 1e-4


# the grouped matmul's and the scan's autograd functions (MoE and hybrid
# training): their CUDA gradients against autograd of the plain versions
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("C", [4, 40, 96])  # skinny, wmma / fp32, wgmma
def test_grouped_matmul_gradients_match_plain_on_gpu(cuda_device, dtype, rtol,
                                                     C):
    """dx through the kernel (one more launch, at the forward's variant for
    the same C), dw one ``torch.bmm``, rows past each group zero, against
    autograd of the plain version on the card."""
    rng = np.random.default_rng(43)
    E, d, f = 6, 64, 48
    x = torch.from_numpy(_np(rng, (E, C, d))).to(cuda_device, dtype)
    w = torch.from_numpy(_np(rng, (E, d, f)) / 8).to(cuda_device, dtype)
    g = torch.from_numpy(_np(rng, (E, C, f))).to(cuda_device, dtype)
    sizes = torch.tensor([0, 1, C // 2, C, 3, C - 1], dtype=torch.int32,
                         device=cuda_device)
    before = ops.launch_counts()["grouped_matmul"]
    ins = [t.detach().requires_grad_() for t in (x, w)]
    got = torch.autograd.grad(ops.grouped_matmul(*ins, sizes), ins, g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["grouped_matmul"] == before + 2
    ins = [t.detach().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(ref.grouped_matmul_ref(*ins, sizes), ins, g)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_close(a, b, rtol)
    dead = torch.arange(C, device=cuda_device)[None, :] >= sizes[:, None]
    assert not bool(got[0][dead].ne(0).any())


@pytest.mark.cuda
def test_rglru_scan_gradients_match_plain_on_gpu(cuda_device):
    """The reverse scan through the kernel (one more launch) and the
    elementwise da, db, with an initial state folded in, against autograd
    of the plain version on the card, in fp32: the model's gates and scan
    are fp32, and in bf16 the plain version's gradient reads its fp32
    carry where the function reads the rounded output."""
    dtype, rtol = torch.float32, 0.0
    rng = np.random.default_rng(44)
    B, S, D = 2, 300, 130
    a = torch.sigmoid(torch.from_numpy(_np(rng, (B, S, D)))).to(cuda_device,
                                                                dtype)
    b = torch.from_numpy(_np(rng, (B, S, D))).to(cuda_device, dtype)
    h0 = torch.from_numpy(_np(rng, (B, D))).to(cuda_device, dtype)
    g = torch.from_numpy(_np(rng, (B, S, D))).to(cuda_device, dtype)

    def grads(scan):
        ins = [t.detach().requires_grad_() for t in (a, b, h0)]
        aa, bb, hh = ins
        bb = torch.cat([bb[:, :1] + aa[:, :1] * hh[:, None], bb[:, 1:]], 1)
        return torch.autograd.grad(scan(aa, bb.contiguous()), ins, g)

    before = ops.launch_counts()["rglru_scan"]
    got = grads(ops.rglru_scan)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan"] == before + 2
    want = grads(ref.rglru_scan_ref)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        _assert_close(x, y, rtol)


# ------------------------------------------------- the modal families' shapes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("H,K,Sq,Sk,hd,causal", [
    (16, 16, 1024, 1024, 64, False),  # seamless's encoder
    (16, 16, 300, 1030, 64, False),   # cross-attention, a ragged Sk tail
    (16, 16, 512, 512, 64, True),     # seamless's decoder self-attention
    (32, 8, 1536, 1536, 128, True),   # pixtral: 1,024 patches + 512 tokens
])
def test_flash_kernel_at_the_modal_shapes_on_gpu(cuda_device, dtype, rtol, H,
                                                 K, Sq, Sk, hd, causal):
    """The flash modes the modal archs serve: non-causal, Sq != Sk with a
    ragged key tail, hd 64, and pixtral's 4:1 GQA at S 1,536; q and K/V are
    passed as the model passes them, head-split transposed views."""
    rng = np.random.default_rng(Sq + Sk + hd)
    B = 2
    q = torch.from_numpy(_np(rng, (B, Sq, H * hd))).to(cuda_device, dtype)
    kv = torch.from_numpy(_np(rng, (B, Sk, 2 * K * hd))).to(cuda_device, dtype)
    qv = q.reshape(B, Sq, H, hd).transpose(1, 2)
    kt = kv[..., :K * hd].reshape(B, Sk, K, hd).transpose(1, 2)
    vt = kv[..., K * hd:].reshape(B, Sk, K, hd).transpose(1, 2)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(qv, kt, vt, causal=causal)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(qv.contiguous(), kt.contiguous(),
                                   vt.contiguous(), causal=causal)
    _assert_close(got, want, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt,rtol", PAGED_DTYPES)
@pytest.mark.parametrize("H,K,hd", [(16, 16, 64),    # seamless: MHA at hd 64
                                    (32, 2, 128)])   # glm4: 16 per KV head
def test_paged_kernel_at_the_modal_layouts_on_gpu(cuda_device, q_dt, kv_dt,
                                                  rtol, H, K, hd):
    """Paged decode at the served step (8 rows at positions 512-543 of 34
    pages of 16): one query head per block (MHA), and two head groups of 8
    per KV head (glm4)."""
    rng = np.random.default_rng(H + K + hd)
    B, ps, n_pp = 8, 16, 34
    P = B * n_pp + 1
    table = (1 + rng.permutation(B * n_pp)).reshape(B, n_pp).astype(np.int32)
    lengths = np.asarray([512 + 31 * b // 7 for b in range(B)], np.int32)
    for b in range(B):
        table[b, lengths[b] // ps + 1:] = 0
    args = [torch.from_numpy(_np(rng, (B, H, hd))).to(cuda_device, q_dt),
            torch.from_numpy(_np(rng, (P, K, ps, hd))).to(cuda_device, kv_dt),
            torch.from_numpy(_np(rng, (P, K, ps, hd))).to(cuda_device, kv_dt),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device)]
    assert cuda_paged.head_groups(H, K) == (2 if H // K == 16 else 1)
    got = ops.paged_attention(*args)
    _assert_close(got, ref.paged_attention_ref(*args), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encdec_prefill_and_decode_launch_counts_on_gpu(cuda_device, compute):
    """A reduced seamless prefill over 280 frames and a 300-token prompt
    launches flash 3 x n_layers times (encoder, self- and
    cross-attention: every query length past 256) and nothing else; one
    paged decode step launches paged decode n_layers times.  In fp32 the
    logits equal the CPU model's (the plain path) within 1e-4; bf16 runs
    hd 64 (the full model's) through the wgmma body."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model
    from repro_torch.serving.batcher import write_pages

    cfg = reduced(get_arch("seamless-m4t-medium"), compute_dtype=compute,
                  head_dim=64 if compute == "bfloat16" else 16)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 300)))
    frames = torch.from_numpy(_np(rng, (2, 280, cfg.d_model)))
    cdt = getattr(torch, compute)
    rows = (1 + np.arange(2 * 20)).reshape(2, 20).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, ShardingConfig(use_kernels=True), device=dev)
        m.init(0)
        before = ops.launch_counts()
        logits, page = m.prefill({"tokens": toks.to(dev),
                                  "frames": frames.to(dev)},
                                 cache_len=310, cache_dtype=cdt)
        mid = ops.launch_counts()
        cache, lay = m.init_paged_cache(2, 310, n_pages=41, page_size=16,
                                        enc_len=280, cache_dtype=cdt)
        write_pages(cache, page, [0, 1], rows, lay)
        step, _ = m.decode_step(logits.argmax(-1), cache,
                                torch.tensor([300, 300], dtype=torch.int32,
                                             device=dev),
                                pages=torch.from_numpy(rows).to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        after = ops.launch_counts()
        L = cfg.n_layers
        want_pf = 3 * L if dev == "cuda" else 0
        assert {n: mid[n] - before[n] for n in mid} == {
            **{n: 0 for n in mid}, "flash_attention": want_pf}
        assert {n: after[n] - mid[n] for n in mid} == {
            **{n: 0 for n in mid}, "paged_attention": L if dev == "cuda" else 0}
        assert bool(torch.isfinite(logits).all() & torch.isfinite(step).all())
        out[dev] = (logits.float().cpu(), step.float().cpu())
    if compute == "float32":
        for a, b in zip(out["cuda"], out["cpu"]):
            assert float((a - b).abs().max()) < 1e-4
