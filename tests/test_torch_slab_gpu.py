"""Slab decode and the xLSTM cells on the card against the CPU's plain path.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_slab_gpu.py

Neither path has a kernel of its own (JAX's slab decode and xLSTM cells
are plain XLA); what these tests hold is the card's arithmetic and
indexing, in fp32 (TF32 off): ``|cuda - cpu| <= 1e-4 + rtol·max|cpu|``
over each output, rtol 1e-4 for slab decode and 1e-3 through the xLSTM
cells, whose exponential gates and signed normaliser amplify fp32 sums
taken in another order (on the CPU a 1e-7 relative change of reduced
xlstm's params moves its logits, largest entry 0.46, by 5.2e-5).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models import recurrent as trec

ATOL = 1e-4
XLSTM_RTOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol=1e-4):
    want = want.float()
    err = float((got.cpu().float() - want).abs().max())
    assert err <= ATOL + rtol * float(want.abs().max()), err


def _np(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_decode_on_gpu_matches_cpu_with_a_stale_row(cuda_device, dtype):
    """GQA 16:8 slab decode at qwen3's head dim, ragged positions and a
    freed row at ``pos == S``: the stale write is clamped on the card (an
    out-of-range index would be a device-side assert) and launches no
    paged-decode kernel; outputs and caches equal the CPU's (bf16: within
    2^-5 of the largest entry)."""
    B, H, K, hd, S, d = 4, 16, 8, 128, 40, 256
    rng = np.random.default_rng(0)
    p = {"wq": _np(rng, (d, H * hd), d ** -0.5),
         "wk": _np(rng, (d, K * hd), d ** -0.5),
         "wv": _np(rng, (d, K * hd), d ** -0.5),
         "wo": _np(rng, (H * hd, d), (H * hd) ** -0.5)}
    x = _np(rng, (B, 1, d))
    ck, cv = _np(rng, (B, K, S, hd)), _np(rng, (B, K, S, hd))
    pos = torch.tensor([0, 17, S - 1, S], dtype=torch.int32)
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rope_theta=1e6, qk_norm=True)

    def run(dev):
        pp = {k: v.to(dev, dtype) for k, v in p.items()}
        k, v = ck.to(dev, dtype), cv.to(dev, dtype)
        y, k, v = tatt.attn_decode(pp, x.to(dev, dtype), k, v, pos.to(dev),
                                   impl="kernels", **kw)
        return y, k, v

    want = run("cpu")
    before = ops.launch_counts()["paged_attention"]
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before
    for g, w in zip(got, want):
        if dtype == torch.float32:
            _close(g, w)
            continue
        # bf16 products round in another order on the card: a few ulps of
        # the largest entry
        err = float((g.cpu().float() - w.float()).abs().max())
        assert err <= 2.0 ** -5 * float(w.float().abs().max()), err


@pytest.mark.cuda
def test_mlstm_cells_on_gpu_match_cpu(cuda_device):
    """The chunked parallel form over 3 query chunks (one ragged), the
    closed-form prefill state and three decode steps at xlstm-125m's
    head dim 192."""
    B, S, H, hd, d = 2, 300, 4, 192, 96
    rng = np.random.default_rng(1)
    dh = H * hd
    p = {"wq": _np(rng, (d, dh), d ** -0.5), "wk": _np(rng, (d, dh), d ** -0.5),
         "wv": _np(rng, (d, dh), d ** -0.5),
         "w_if": _np(rng, (d, 2 * H), d ** -0.5),
         "wo": _np(rng, (dh, d), dh ** -0.5),
         "ogate": _np(rng, (d, dh), d ** -0.5)}
    x = _np(rng, (B, S + 3, d))
    kw = dict(n_heads=H, head_dim=hd)

    def run(dev):
        pp = {k: v.to(dev) for k, v in p.items()}
        xx = x.to(dev)
        y, st = trec.mlstm_apply(pp, xx[:, :S], return_state=True,
                                 q_chunk=128, **kw)
        out = [y, st["C"], st["n"], st["m"]]
        for t in range(S, S + 3):
            y, st = trec.mlstm_decode(pp, xx[:, t], st, **kw)
            out.append(y)
        return out + [st["C"]]

    for g, w in zip(run(cuda_device), run("cpu")):
        _close(g, w, XLSTM_RTOL)


@pytest.mark.cuda
def test_slstm_cells_on_gpu_match_cpu(cuda_device):
    """The sequential scan over 64 tokens and two decode steps."""
    B, S, H, hd, d = 2, 64, 4, 192, 96
    rng = np.random.default_rng(2)
    dh = H * hd
    p = {"w_in": _np(rng, (d, 4 * dh), d ** -0.5),
         "r": _np(rng, (4, H, hd, hd), hd ** -0.5),
         "wo": _np(rng, (dh, d), dh ** -0.5)}
    x = _np(rng, (B, S + 2, d))
    kw = dict(n_heads=H, head_dim=hd)

    def run(dev):
        pp = {k: v.to(dev) for k, v in p.items()}
        xx = x.to(dev)
        y, st = trec.slstm_apply(pp, xx[:, :S], **kw)
        out = [y]
        for t in range(S, S + 2):
            y, st = trec.slstm_decode(pp, xx[:, t], st, **kw)
            out.append(y)
        return out + [st[k] for k in ("c", "n", "h", "m")]

    for g, w in zip(run(cuda_device), run("cpu")):
        _close(g, w, XLSTM_RTOL)


@pytest.mark.cuda
def test_reduced_xlstm_prefill_and_decode_on_gpu_match_cpu(cuda_device):
    """Reduced xlstm-125m in fp32: a 300-token prefill (two mLSTM query
    chunks) and a decode step launch no kernel and equal the CPU's."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_arch("xlstm-125m"))
    sh = ShardingConfig(use_kernels=True)
    cpu = build_model(cfg, sh, device="cpu").init(5)
    gpu = build_model(cfg, sh, device="cuda")
    gpu.load_state(dict(cpu.impl.named_parameters()))
    toks = torch.randint(0, cfg.vocab, (2, 300),
                         generator=torch.Generator().manual_seed(6))

    def run(model, dev):
        logits, cache = model.prefill({"tokens": toks.to(dev)}, cache_len=310,
                                      cache_dtype=torch.float32)
        step, _ = model.decode_step(logits.argmax(dim=-1), cache, 300)
        return logits, step

    want = run(cpu, "cpu")
    before = ops.launch_counts()
    got = run(gpu, cuda_device)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    for g, w in zip(got, want):
        _close(g, w, XLSTM_RTOL)
