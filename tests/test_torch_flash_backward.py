"""The flash backward's plain version against autograd and JAX, on the CPU.

``ref.flash_attention_backward_ref`` writes out the gradient the backward
kernel (``csrc/flash_attention_bwd.cu``) computes, from the forward's
output and log-sum-exp: on a CPU tensor ``ops.flash_attention``'s
backward is this function.  The same numpy inputs (q, k, v, the
cotangent dO; o and lse from the plain forward) go through:

* autograd of the plain forward ``ref.flash_attention_ref``, fp32, within
  1e-5 of each gradient's largest entry (the two sum in other orders);
* ``jax.vjp`` of the JAX package's ``repro.kernels.ops.flash_attention``
  (the Pallas kernel in interpret mode, its ``custom_vjp``), within
  ``tests/test_kernels.py::test_flash_kernel_custom_vjp``'s 1e-4;
* the plain forward's log-sum-exp against a log-sum-exp of the JAX
  oracle's scores (``repro/kernels/ref.py``), 1e-5.

Cases: causal and not, Sq != Sk non-causal, H/K of 1, 2 and 4, head dims
16 and 64, a ragged S (75: neither the port's 64-row tiles nor the Pallas
blocks divide it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention_bwd as bwd_k

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


# (B, H, K, Sq, Sk, hd, causal)
CASES = {
    "mha_causal": (1, 2, 2, 64, 64, 16, True),
    "gqa2_full": (1, 4, 2, 64, 64, 64, False),
    "mqa4_causal": (2, 4, 1, 96, 96, 16, True),
    "cross": (1, 2, 1, 40, 72, 64, False),
    "ragged_causal": (1, 4, 2, 75, 75, 16, True),
}


def _inputs(case):
    B, H, K, Sq, Sk, hd, causal = CASES[case]
    rng = np.random.default_rng(sum(CASES[case][:6]))
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, Sk, hd)).astype(np.float32)
    do = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    return q, k, v, do, causal


def _plain_backward(q, k, v, do, causal):
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                     return_lse=True)
    return ref.flash_attention_backward_ref(qt, kt, vt, o, lse, gt,
                                            causal=causal)


def _relative(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("case", list(CASES))
def test_backward_ref_matches_autograd_of_plain_forward(case):
    q, k, v, do, causal = _inputs(case)
    got = _plain_backward(q, k, v, do, causal)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*ins, causal=causal),
                               ins, torch.from_numpy(do))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype == torch.float32
        assert _relative(a, b) <= 1e-5, (name, _relative(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_backward_ref_matches_jax_pallas_vjp(case):
    """JAX's flash_attention (Pallas, interpret mode; blocks of 32 rows, so
    several query and key blocks and a ragged last one) and its
    custom_vjp's gradient, against the plain backward within 1e-4."""
    q, k, v, do, causal = _inputs(case)
    got = _plain_backward(q, k, v, do, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_ops.flash_attention(
        q_, k_, v_, causal=causal, block_q=32, block_k=32), q, k, v)
    want = vjp(jnp.asarray(do))
    for name, a, b in zip("qkv", got, want):
        err = float(np.max(np.abs(a.numpy() - np.asarray(b))))
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lse_matches_jax_oracle_scores(case):
    """The plain forward's second output against ``logsumexp`` over the
    scaled, masked scores the JAX oracle softmaxes (its causal mask is
    bottom-right, the port's top-left: they agree at Sq == Sk, the only
    causal cases)."""
    q, k, v, _, causal = _inputs(case)
    B, H, K, Sq, Sk, hd, _ = CASES[case]
    _, lse = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=causal, return_lse=True)
    kk = jnp.repeat(jnp.asarray(k), H // K, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kk).astype(jnp.float32) / np.sqrt(hd)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((Sq, Sk), bool), k=Sk - Sq)[None, None],
                      s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert float(np.max(np.abs(lse.numpy() - want))) < 1e-5


def test_cpu_backward_goes_through_the_plain_backward(monkeypatch):
    """``ops.flash_attention``'s gradient on the CPU is the plain backward
    fed the forward's saved output and log-sum-exp (never the plain
    forward again), and nothing is compiled or launched."""
    q, k, v, do, causal = _inputs("mqa4_causal")
    want = _plain_backward(q, k, v, do, causal)

    def no_nvcc():
        raise AssertionError("nvcc must not be looked up for CPU tensors")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*ins, causal=causal)

    def forbidden(*a, **kw):
        raise AssertionError("the backward recomputed the plain forward")

    monkeypatch.setattr(ref, "flash_attention_ref", forbidden)
    ops.reset_launch_counts()
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(ops.launch_counts().values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's own wrapper takes CUDA tensors only: a CPU tensor
    raises before anything is built."""
    q, k, v, do, causal = _inputs("mha_causal")
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ref.flash_attention_ref(*t[:3], causal=causal, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_k.flash_attention_backward(t[0], t[1], t[2], o, lse, t[3])
    assert bwd_k.KERNEL._fn is None


@pytest.mark.parametrize("Sq,Sk,causal", [(75, 75, True), (40, 72, False),
                                          (72, 40, True)])
def test_work_counts_the_scored_pairs(Sq, Sk, causal):
    """``work``'s FLOPs are ten per head-dim entry of each scored pair (five
    products), its bytes every input and output once."""
    B, H, K, hd = 2, 4, 2, 16
    pairs = int(ref._causal_mask(Sq, Sk, "cpu").sum()) if causal else Sq * Sk
    flops, nbytes = bwd_k.work(B, H, K, Sq, Sk, hd, causal, 2)
    assert flops == 10 * B * H * hd * pairs
    assert nbytes == (4 * B * H * Sq + 4 * B * K * Sk) * hd * 2 + 4 * B * H * Sq
