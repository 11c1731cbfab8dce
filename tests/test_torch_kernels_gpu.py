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

from repro_torch.kernels import ops, ref


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
