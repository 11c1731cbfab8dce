"""The port's Griffin recurrent block and RG-LRU scan against the JAX package.

The same numpy inputs go through ``repro.models.recurrent`` /
``repro.kernels`` and ``repro_torch.models.recurrent`` /
``repro_torch.kernels``.  The scan's plain version (what the port's kernel
wrapper computes for a CPU tensor) is held to the JAX oracle and to the
Pallas kernel in interpret mode with ``tests/test_kernels.py``'s
tolerances: 1e-4, and 1e-3 for the long-decay case.  The block functions
are held to 1e-5 in fp32 (the same arithmetic in another summation order),
except where the two sides scan differently — the JAX model's
``associative_scan`` against the port's doubling scan or its kernel's
sequential one — which ``test_kernels.py:184`` holds to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels import rglru_scan as jax_rglru_scan
from repro.models import recurrent as jrec
from repro_torch.kernels import ops, ref
from repro_torch.models import recurrent as trec

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 1e-5
SCAN_ATOL = 1e-4
D = 64


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _gates(seed, B, S, Dm):
    """Decay gates in (0, 1) and inputs, as tests/test_kernels.py:163."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, Dm))))
    return a.astype(np.float32), _np(rng, (B, S, Dm))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err < atol, err


def _griffin_params(seed, d=D, dtype=jnp.float32):
    """JAX ``griffin_block_init`` params as numpy (lam fp32)."""
    p = jrec.griffin_block_init(jax.random.PRNGKey(seed), d, d, dtype)
    return jax.tree.map(np.asarray, p)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ------------------------------------------------------------------ the scan


@pytest.mark.parametrize("B,S,Dm", [(1, 64, 64), (2, 300, 130), (3, 17, 8)])
def test_scan_ref_matches_jax_oracle(B, S, Dm):
    a, b = _gates(B * 1000 + S, B, S, Dm)
    want = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got, want, SCAN_ATOL)


def test_scan_ref_long_decay_matches_jax_oracle():
    """Decay 0.999 over 512 steps (test_kernels.py:173): stays finite and
    within 1e-3 of the oracle."""
    a = np.full((1, 512, 32), 0.999, np.float32)
    b = np.full((1, 512, 32), 0.01, np.float32)
    want = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-3)


def test_scan_ref_matches_pallas_kernel_in_interpret_mode():
    a, b = _gates(5, 2, 300, 130)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=64,
                          block_d=64, interpret=True)
    _close(ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)), want,
           SCAN_ATOL)


def test_scan_ref_keeps_an_fp32_carry_and_returns_the_input_dtype():
    """bf16 in, bf16 out, each step rounded once from the fp32 carry —
    not a bf16 recurrence."""
    a, b = _gates(6, 2, 40, 16)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = ref.rglru_scan_ref(ta, tb)
    want = ref.rglru_scan_ref(ta.float(), tb.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# ---------------------------------------------------------------- the RG-LRU


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches_jax(use_kernels, with_h0):
    p = _griffin_params(0)["rglru"]
    rng = np.random.default_rng(1)
    x = _np(rng, (2, 96, D))
    h0 = _np(rng, (2, D)) if with_h0 else None
    yj, hj = jax.jit(jrec.rglru_apply)(_j(p), jnp.asarray(x),
                                       None if h0 is None else jnp.asarray(h0))
    y, h = trec.rglru_apply(_t(p), torch.from_numpy(x),
                            None if h0 is None else torch.from_numpy(h0),
                            use_kernels=use_kernels)
    assert h.dtype == torch.float32
    _close(y, yj, SCAN_ATOL)
    _close(h, hj, SCAN_ATOL)


def test_rglru_gates_and_decode_match_jax():
    p = _griffin_params(1)["rglru"]
    rng = np.random.default_rng(2)
    x, h = _np(rng, (3, D)), _np(rng, (3, D))
    log_a, bj = jrec._rglru_gates(_j(p), jnp.asarray(x)[:, None])
    tl, tb = trec._rglru_gates(_t(p), torch.from_numpy(x)[:, None])
    _close(tl, log_a)
    _close(tb, bj)
    yj, hj = jrec.rglru_decode(_j(p), jnp.asarray(x), jnp.asarray(h))
    y, hn = trec.rglru_decode(_t(p), torch.from_numpy(x), torch.from_numpy(h))
    _close(y, yj)
    _close(hn, hj)


# ------------------------------------------------------------------ conv1d


@pytest.mark.parametrize("S", [1, 2, 9])
def test_conv1d_apply_and_decode_match_jax(S):
    """The sequence conv, then one decode token against the prefill's
    buffer; S < width - 1 pads the buffer on the left."""
    p = _griffin_params(2)["conv"]
    rng = np.random.default_rng(3 + S)
    x, x_t = _np(rng, (2, S, D)), _np(rng, (2, D))
    _close(trec.conv1d_apply(_t(p), torch.from_numpy(x)),
           jrec.conv1d_apply(_j(p), jnp.asarray(x)))
    buf = np.pad(x, ((0, 0), (max(3 - S, 0), 0), (0, 0)))[:, -3:]
    yj, bj = jrec.conv1d_decode(_j(p), jnp.asarray(x_t), jnp.asarray(buf))
    y, bt = trec.conv1d_decode(_t(p), torch.from_numpy(x_t),
                               torch.from_numpy(buf))
    _close(y, yj)
    _close(bt, bj)


# ----------------------------------------------------------- Griffin block


@pytest.mark.parametrize("S", [2, 40])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_griffin_block_apply_then_decode_matches_jax(S, use_kernels):
    """Prefill over S tokens (S = 2 < width - 1: a zero-padded conv
    buffer), then three decode steps on the handed-off state."""
    p = _griffin_params(3)
    rng = np.random.default_rng(4 + S)
    x = _np(rng, (2, S, D))
    yj, sj = jax.jit(jrec.griffin_block_apply)(_j(p), jnp.asarray(x))
    y, st = trec.griffin_block_apply(_t(p), torch.from_numpy(x),
                                     use_kernels=use_kernels)
    _close(y, yj, SCAN_ATOL)
    _close(st["h"], sj["h"], SCAN_ATOL)
    _close(st["conv"], sj["conv"])
    assert st["h"].dtype == torch.float32
    for step in range(3):
        x_t = _np(rng, (2, D))
        yj, sj = jax.jit(jrec.griffin_block_decode)(_j(p), jnp.asarray(x_t),
                                                    sj)
        y, st = trec.griffin_block_decode(_t(p), torch.from_numpy(x_t), st)
        _close(y, yj, SCAN_ATOL)
        _close(st["h"], sj["h"], SCAN_ATOL)
        _close(st["conv"], sj["conv"])


def test_griffin_block_uses_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation; torch's default
    (erf) differs by ~1e-3 on these inputs, far above the tolerance."""
    p = _griffin_params(4)
    x = _np(np.random.default_rng(5), (1, 4, D), 3.0)
    yj, _ = jax.jit(jrec.griffin_block_apply)(_j(p), jnp.asarray(x))
    y, _ = trec.griffin_block_apply(_t(p), torch.from_numpy(x))
    _close(y, yj, SCAN_ATOL)
    gx = torch.from_numpy(x) @ _t(p)["w_gate"]
    erf = torch.nn.functional.gelu(gx)
    assert float((trec._gelu(gx) - erf).abs().max()) > 1e-4


def test_griffin_state_init():
    st = trec.griffin_state_init(3, D, dtype=torch.bfloat16)
    sj = jrec.griffin_state_init(3, D, dtype=jnp.bfloat16)
    assert st["h"].dtype == torch.float32 and not st["h"].any()
    assert st["conv"].dtype == torch.bfloat16 and not st["conv"].any()
    assert tuple(st["h"].shape) == sj["h"].shape
    assert tuple(st["conv"].shape) == sj["conv"].shape
