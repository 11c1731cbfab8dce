"""The port's kernels against the JAX Pallas kernels.

On the CPU the port's kernel entry points compute their plain PyTorch
versions (``repro_torch.kernels.ref``); these are held against the JAX
Pallas kernels run in interpret mode, at the shapes of
``tests/test_kernels.py``, with that file's fp32 tolerance (2e-4: both
sides accumulate in fp32, in different orders).  The CUDA kernels
themselves are held against the same plain versions on the card
(``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import grouped_matmul as jax_gmm
from repro.kernels.paged_attention import paged_attention as jax_paged_kernel
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import grouped_matmul as cuda_gmm
from repro_torch.kernels import paged_attention as cuda_paged
from repro_torch.kernels import rglru_scan as cuda_scan

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 2e-4


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _paged_inputs(seed, B, H, K, hd, ps, n_pp):
    """The layout of tests/test_kernels.py:75 — distinct, deliberately
    non-contiguous pages per row; odd rows full, even rows half a page."""
    rng = np.random.default_rng(seed)
    P = B * n_pp + 2
    q = _np(rng, (B, H, hd))
    kp = _np(rng, (P, K, ps, hd))
    vp = _np(rng, (P, K, ps, hd))
    table = (1 + np.arange(B * n_pp).reshape(B, n_pp)[:, ::-1]).astype(np.int32)
    lengths = np.asarray(
        [(n_pp * ps - 1) if b % 2 else (ps // 2) for b in range(B)], np.int32)
    return q, kp, vp, np.ascontiguousarray(table), lengths


@pytest.mark.parametrize("B,H,K,S,hd", [
    (1, 4, 4, 64, 32),     # MHA, aligned
    (2, 8, 2, 300, 64),    # GQA 4:1, ragged seq
    (1, 4, 1, 128, 128),   # MQA
    (2, 2, 2, 17, 16),     # tiny, sub-block
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_kernel(B, H, K, S, hd, causal):
    rng = np.random.default_rng(100 + S)
    q, k, v = _np(rng, (B, H, S, hd)), _np(rng, (B, K, S, hd)), _np(rng, (B, K, S, hd))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=64, block_k=64))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ref_returns_q_dtype(dtype):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_np(rng, (1, 2, 96, 32))).to(dtype)
               for _ in range(3))
    out = ref.flash_attention_ref(q, k, v)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    assert out.dtype == dtype
    tol = 2e-1 if dtype == torch.bfloat16 else 1e-6  # test_kernels.py's bf16 atol
    assert float((out.float() - want).abs().max()) < tol


@pytest.mark.parametrize("B,H,K,hd,ps,n_pp", [
    (2, 4, 4, 32, 8, 3),    # MHA
    (3, 8, 2, 64, 16, 2),   # GQA 4:1
    (1, 4, 1, 128, 8, 4),   # MQA
])
def test_paged_ref_matches_pallas_kernel(B, H, K, hd, ps, n_pp):
    q, kp, vp, table, lengths = _paged_inputs(2, B, H, K, hd, ps, n_pp)
    want = np.asarray(jax_paged_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True))
    got = ops.paged_attention(*(torch.from_numpy(a) for a in
                                (q, kp, vp, table, lengths)))
    assert got.shape == want.shape
    assert float(np.max(np.abs(got.numpy() - want))) < ATOL


def test_paged_ref_unmapped_pages_are_masked():
    """Logical pages past a row's position may alias the trash page (entry
    0) — their content must never leak (mirrors test_kernels.py:97)."""
    rng = np.random.default_rng(3)
    B, H, K, hd, ps, P = 1, 2, 2, 16, 4, 5
    q = torch.from_numpy(_np(rng, (B, H, hd)))
    kp = torch.from_numpy(_np(rng, (P, K, ps, hd)))
    vp = torch.from_numpy(_np(rng, (P, K, ps, hd)))
    lengths = torch.tensor([ps - 1], dtype=torch.int32)
    t1 = torch.tensor([[1, 0, 0]], dtype=torch.int32)  # tail unmapped → trash
    t2 = torch.tensor([[1, 3, 4]], dtype=torch.int32)  # tail mapped elsewhere
    out1 = ops.paged_attention(q, kp, vp, t1, lengths)
    out2 = ops.paged_attention(q, kp, vp, t2, lengths)
    assert float((out1 - out2).abs().max()) < 1e-6
    want = np.asarray(jax_paged_kernel(
        *(jnp.asarray(a.numpy()) for a in (q, kp, vp, t1, lengths)),
        interpret=True))
    assert float(np.max(np.abs(out1.numpy() - want))) < ATOL


def test_ops_on_cpu_need_no_nvcc(monkeypatch):
    """CPU tensors take the plain versions: nothing is compiled or loaded,
    and no launch is counted."""
    def no_nvcc():
        raise AssertionError("nvcc must not be looked up for CPU tensors")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    ops.reset_launch_counts()
    q, kp, vp, table, lengths = _paged_inputs(4, 2, 4, 2, 16, 4, 3)
    ops.paged_attention(*(torch.from_numpy(a) for a in
                          (q, kp, vp, table, lengths)))
    x = torch.randn(1, 4, 300, 16)
    ops.flash_attention(x, x[:, :2], x[:, :2])
    ops.grouped_matmul(torch.randn(2, 4, 8), torch.randn(2, 8, 3),
                       torch.tensor([4, 1], dtype=torch.int32))
    ops.rglru_scan(torch.rand(2, 5, 8), torch.randn(2, 5, 8))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_backward": 0,
                                   "paged_attention": 0,
                                   "grouped_matmul": 0, "rglru_scan": 0}
    assert all(k._fn is None for k in ops.KERNELS.values())


def test_launch_keys_count_each_launch_by_its_key(monkeypatch):
    """A launch adds one to its kernel's count and, where the wrapper names
    a key, to that key's count; the reset clears both.  The scan's
    backward goes to the reverse launch's wrapper, its forward to the
    forward's."""
    kernel = ops.KERNELS["rglru_scan"]
    monkeypatch.setattr(kernel, "_fn", lambda *args: 0)
    ops.reset_launch_counts()
    kernel.launch(1, 2)
    kernel.launch(1, 2, key=("a",))
    kernel.launch(1, 2, key=("a",))
    assert kernel.launches == 3
    assert ops.launch_keys()["rglru_scan"] == {("a",): 2}
    ops.reset_launch_counts()
    assert kernel.launches == 0 and ops.launch_keys()["rglru_scan"] == {}

    calls = []

    def fake_scan(a, b):
        calls.append(False)
        return ref.rglru_scan_ref(a, b)

    def fake_reverse(a, h, g):
        calls.append(True)
        return ref.rglru_scan_backward_ref(a, h, g)

    monkeypatch.setattr(ops, "_device_type", lambda *tensors: "cuda")
    monkeypatch.setattr(ops._scan, "rglru_scan", fake_scan)
    monkeypatch.setattr(ops._scan, "rglru_scan_backward", fake_reverse)
    a = torch.rand(2, 5, 8, requires_grad=True)
    ops.rglru_scan(a, torch.randn(2, 5, 8)).sum().backward()
    assert calls == [False, True]


def test_paged_attention_refuses_a_gradient():
    """Paged decode has no gradient in either package: with grad mode on
    and an input that requires one it raises (on the card it would
    otherwise return a detached result); under ``no_grad``, or with no
    such input, it runs."""
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged_inputs(6, 2, 4, 2, 16, 4, 3))
    want = ops.paged_attention(q, kp, vp, table, lengths)
    for i in range(3):
        args = [q, kp, vp]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no gradient"):
            ops.paged_attention(*args, table, lengths)
        with torch.no_grad():
            assert torch.equal(ops.paged_attention(*args, table, lengths),
                               want)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise — they never
    compute on the CPU themselves."""
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged_inputs(5, 2, 4, 2, 16, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_paged.paged_attention(q, kp, vp, table, lengths)
    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gmm.grouped_matmul(torch.randn(2, 4, 8), torch.randn(2, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan.rglru_scan(torch.rand(2, 5, 8), torch.randn(2, 5, 8))


def test_library_hash_follows_shared_headers(monkeypatch, tmp_path):
    """A kernel's built library is named by a hash of its source, the
    shared headers ``csrc/*.cuh`` and the flags: editing a header names a
    new library (it is rebuilt), and restoring it names the old one."""
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    kernel = build.CudaKernel("flash_attention", "flash_attention.cu",
                              "repro_flash_attention", [])
    first = kernel.library
    header = tmp_path / "hopper.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    assert kernel.library != first
    header.write_text(text)
    assert kernel.library == first
    (tmp_path / "flash_attention.cu").write_text("// edited source\n")
    assert kernel.library != first


def test_profile_groups_follow_kernel_names():
    """``launch/profile.py`` files each kernel of ``csrc/<kernel>.cu`` under
    that kernel's group, by name."""
    import re

    from repro_torch.launch.profile import GROUPS

    for src in build.CSRC.glob("*.cu"):
        names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))? "
                           r"(\w+)\(", src.read_text())
        assert names, src
        for name in names:
            group = next((g for g, key in GROUPS if key in name), "other")
            assert group == src.stem, (name, group)


def test_train_breakdown_files_backward_launches_by_autograd_node():
    """``launch/profile.py``'s train breakdown: a grouped-matmul or scan
    kernel under its function's backward node is dx or the reverse scan,
    one under the forward op is the forward (a ctypes launch is filed
    under the node's op, outside the backward's ``record_function``
    range).  On the CPU no kernel runs, so stand-in kernels are hung on
    the profiled ops."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import train_breakdown

    x = torch.randn(2, 4, 8, requires_grad=True)
    w = torch.randn(2, 8, 3, requires_grad=True)
    a = torch.rand(2, 5, 3, requires_grad=True)
    b = torch.randn(2, 5, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("repro.train.forward"):
            y = ops.grouped_matmul(x, w).sum() + ops.rglru_scan(a, b).sum()
        with torch.profiler.record_function("repro.train.backward"):
            y.backward()
    events = prof.events()
    phases = {n: (e.time_range.start, e.time_range.end) for e in events
              for n in ("forward", "backward") if e.name == "repro.train." + n}
    kernel = {"_GroupedMatmul": "gmm_wgmma_kernel",
              "_RGLRUScan": "rglru_scan_kernel"}
    for e in events:
        name = kernel.get(e.name.removesuffix("Backward"))
        if name:
            e.kernels.append(SimpleNamespace(name=name, duration=1.0))
    got = {g: v for g, v in train_breakdown(events, phases).items() if v}
    assert got == {"gmm_forward": 1.0, "gmm_dx": 1.0, "scan_forward": 1.0,
                   "scan_reverse": 1.0}


@pytest.mark.parametrize("dtype,C,d,f,offset,want", [
    (torch.bfloat16, 341, 2048, 1408, 0, "wgmma"),  # qwen2-moe's prefill
    (torch.bfloat16, 64, 96, 80, 0, "wgmma"),
    (torch.bfloat16, 4, 2048, 1408, 0, "skinny"),   # its decode step
    (torch.bfloat16, 63, 96, 80, 0, "wmma"),
    (torch.bfloat16, 16, 96, 80, 0, "skinny"),      # the skinny threshold
    (torch.bfloat16, 17, 96, 80, 0, "wmma"),
    (torch.bfloat16, 1, 1408, 2048, 0, "skinny"),
    (torch.bfloat16, 4, 36, 80, 0, "wmma"),         # skinny needs d % 8
    (torch.bfloat16, 4, 96, 80, 1, "wmma"),         # and aligned x
    (torch.bfloat16, 4, 16384, 80, 0, "wmma"),      # x[e] past shared memory
    (torch.float32, 4, 2048, 1408, 0, "skinny"),
    (torch.float32, 16, 1408, 2048, 0, "skinny"),
    (torch.float32, 17, 96, 80, 0, "fp32"),
    (torch.float32, 4, 96, 44, 0, "fp32"),          # f % 8
    (torch.bfloat16, 64, 36, 80, 0, "wmma"),        # d % 8
    (torch.bfloat16, 64, 96, 44, 0, "wmma"),        # f % 8
    (torch.bfloat16, 64, 96, 80, 1, "wmma"),        # x off 16 bytes
    (torch.float32, 341, 2048, 1408, 0, "fp32"),
])
def test_gmm_variant_rule(dtype, C, d, f, offset, want):
    """The grouped matmul's variant by shape: skinny for either dtype with
    C <= 16, d and f multiples of 8, 16-byte aligned operands and x[e]
    within shared memory; wgmma for bf16 with C >= 64 and the same
    alignment; wmma for any other bf16 call; fp32 for any other float32
    call (what the wrapper launches; the tensors here are only measured,
    never computed on)."""
    x = torch.empty(2 * C * d + offset, dtype=dtype)[offset:].view(2, C, d)
    w = torch.empty(2, d, f, dtype=dtype)
    assert cuda_gmm.variant(x, w) == want


# ------------------------------------------------------------- grouped matmul
# tests/test_kernels.py:118-152 — the JAX kernel in interpret mode, its
# tolerances: 1e-3 in fp32 (values of size ~10, summed in other orders),
# 8 × 0.2 in bf16 for the JAX side against the fp32 oracle; here both sides
# round the same fp32 sums once to bf16, so they differ by one bf16 ulp.


@pytest.mark.parametrize("E,C,d,f", [
    (2, 64, 64, 64),
    (4, 96, 160, 200),   # ragged vs blocks
    (1, 16, 32, 48),
])
def test_gmm_ref_matches_pallas_kernel(E, C, d, f):
    rng = np.random.default_rng(E * 1000 + C)
    x, w = _np(rng, (E, C, d)), _np(rng, (E, d, f))
    want = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w), block_c=32,
                              block_f=64, block_d=64))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-3


def test_gmm_ref_ragged_groups_match_pallas_kernel():
    E, C, d, f = 4, 64, 96, 80
    rng = np.random.default_rng(6)
    x, w = _np(rng, (E, C, d)), _np(rng, (E, d, f))
    sizes = np.asarray([64, 33, 0, 1], np.int32)
    want = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(sizes), block_c=32, block_f=32,
                              block_d=32))
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(sizes)).numpy()
    assert float(np.max(np.abs(got - want))) < 1e-3
    # rows beyond the group size are exactly zero, on both sides
    for e, n in enumerate(sizes):
        assert not got[e, n:].any() and not want[e, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_ref_dtypes_match_pallas_kernel(dtype):
    E, C, d, f = 2, 32, 64, 64
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_np(rng, (E, C, d))).to(dtype)
    w = torch.from_numpy(_np(rng, (E, d, f))).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_gmm(jnp.asarray(x.float().numpy(), jdt),
                   jnp.asarray(w.float().numpy(), jdt),
                   block_c=16, block_f=32, block_d=32)
    assert want.dtype == jdt
    got = ops.grouped_matmul(x, w)
    assert got.dtype == dtype
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    excess = (got.float() - want).abs() - rtol * want.abs()
    assert float(excess.max()) < 1e-3


@pytest.mark.parametrize("B,K,n_pp,sms,n_hg,want", [
    (8, 8, 34, 132, 1, 9),     # qwen3's decode step: 576 blocks
    (8, 16, 34, 132, 1, 5),    # qwen2-moe's: 640 blocks
    (40, 16, 4, 132, 1, 1),    # blocks enough without a split
    (1, 1, 1, 132, 1, 1),      # one page
    (2, 1, 200, 132, 1, 29),   # 32 wanted: 7 pages each, so 29 own pages
    (8, 1, 34, 132, 2, 17),    # two head groups (rep 16)
    (8, 8, 34, 114, 1, 7),     # another SM count: 8 wanted, 5 pages each
])
def test_paged_num_splits_from_shapes(B, K, n_pp, sms, n_hg, want):
    """The paged kernel's split count is a function of shapes only (the
    positions lie on the device): about ``BLOCKS_PER_SM`` blocks per SM."""
    assert cuda_paged.num_splits(B, K, n_pp, sms, n_hg) == want


def test_paged_num_splits_every_split_owns_a_page():
    for B in (1, 3, 8, 40):
        for K in (1, 2, 8, 16):
            for n_pp in (1, 2, 5, 34, 100, 513):
                s = cuda_paged.num_splits(B, K, n_pp, 132)
                pps = -(-n_pp // s)
                assert 1 <= s <= min(n_pp, cuda_paged.MAX_SPLITS)
                assert (s - 1) * pps < n_pp <= s * pps


@pytest.mark.parametrize("H,K,want", [(16, 8, 1), (16, 16, 1), (16, 2, 1),
                                      (16, 1, 2), (24, 2, 2), (8, 1, 1)])
def test_paged_head_groups(H, K, want):
    assert cuda_paged.head_groups(H, K) == want
