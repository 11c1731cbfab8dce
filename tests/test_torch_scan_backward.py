"""The RG-LRU scan's gradient: its plain version against JAX and autograd,
on the CPU.

``ref.rglru_scan_backward_ref`` writes out what the reverse launch of
``csrc/rglru_scan.cu`` computes for the cotangent g of ``h =
rglru_scan(a, b)``: ``dh_t = a_{t+1}·dh_{t+1} + g_t`` walked backwards in
time with an fp32 carry, ``db = dh`` and ``da_t = dh_t·h_{t-1}``.  On a
CPU tensor ``ops.rglru_scan_backward`` is this function.  The same numpy
inputs go through:

* ``jax.vjp`` of the JAX package's ``repro.kernels.ref.rglru_scan_ref``
  (a ``lax.scan``), fp32, with and without an initial state folded into
  b_0 as the model folds it, within 1e-5 of each gradient's largest entry;
* autograd of the port's plain forward ``ref.rglru_scan_ref``, fp32 and
  float64;
* the flipped composition the port ran before the reverse launch (the
  forward scan on flipped, shifted copies, then the products), bit for
  bit in fp32, bf16 and float64.

The shape-only branch counts the reverse launch's own work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as scan_k

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


# (B, S, D): ragged S and D, one step, one feature
SHAPES = [(2, 37, 13), (3, 64, 8), (1, 1, 5), (2, 19, 1)]


def _inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D))))).astype(
        np.float32)
    b, g = (rng.standard_normal((B, S, D)).astype(np.float32)
            for _ in range(2))
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, g, h0


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("B,S,D", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_reverse_matches_jax_vjp(B, S, D, with_h0):
    """(da, db) of the plain reverse, chained through the fold h1 = a1·h0
    + b1 where there is an initial state, against ``jax.vjp`` of the JAX
    oracle over (a, b, h0)."""
    a, b, g, h0 = _inputs(B, S, D, seed=S + D)
    if not with_h0:
        h0 = np.zeros_like(h0)

    def jax_fn(a, b, h0):
        return jax_ref.rglru_scan_ref(a, b.at[:, 0].add(a[:, 0] * h0))

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (a, b, h0)))
    want = vjp(jnp.asarray(g))

    ta, tb, tg, th0 = (torch.from_numpy(x) for x in (a, b, g, h0))
    b1 = tb.clone()
    b1[:, 0] += ta[:, 0] * th0
    h = ref.rglru_scan_ref(ta, b1)
    da, db = ref.rglru_scan_backward_ref(ta, h, tg)
    da = da.clone()
    da[:, 0] += db[:, 0] * th0  # the fold's share of a_1's gradient
    got = (da, db, db[:, 0] * ta[:, 0])
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        assert _rel(x.numpy(), y) <= 1e-5, name


@pytest.mark.parametrize("B,S,D", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-14)])
def test_ops_backward_matches_autograd_of_the_plain_forward(B, S, D, dtype,
                                                            tol):
    """On CPU tensors the autograd function's backward is the plain
    reverse; it agrees with autograd through the plain forward's loop."""
    a, b, g, _ = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(B, S, D, seed=2 * S + D))
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    got = torch.autograd.grad(ops.rglru_scan(*ins), ins, g)
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(ref.rglru_scan_ref(*ins), ins, g)
    direct = ops.rglru_scan_backward(a, ref.rglru_scan_ref(a, b), g)
    for x, y, z in zip(got, want, direct):
        assert x.dtype == dtype and torch.equal(x, z)
        assert _rel(x.numpy(), y.numpy()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("B,S,D", SHAPES)
def test_plain_reverse_equals_the_flipped_composition(B, S, D, dtype):
    """The reverse loop rounds as the flipped forward scan and the
    elementwise products rounded: the same bits in every dtype."""
    a, b, g, _ = (torch.from_numpy(x).to(dtype)
                  for x in _inputs(B, S, D, seed=3 * S + D))
    h = ref.rglru_scan_ref(a, b)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    dh = ref.rglru_scan_ref(a_next.flip(1), g.flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    got = ref.rglru_scan_backward_ref(a, h, g)
    for x, y in zip(got, (dh * h_prev, dh)):
        assert x.dtype == dtype and torch.equal(x, y)


def test_shape_only_reverse_counts_its_own_work():
    """On ``"meta"`` the backward is one shape-only ``rglru_scan`` call
    with the reverse launch's work (a, g, h read; da, db written), and no
    card launch."""
    meta = dict(device="meta")
    a, h, g = (torch.empty(2, 10, 6, **meta) for _ in range(3))
    ops.reset_shape_only()
    launches = ops.launch_counts()
    da, db = ops.rglru_scan_backward(a, h, g)
    assert all((t.shape, t.dtype, t.device.type) == (a.shape, a.dtype, "meta")
               for t in (da, db))
    rec = ops.SHAPE_ONLY["rglru_scan"]
    flops, nbytes = scan_k.work(2, 10, 6, 4, reverse=True)
    assert [rec["calls"], rec["flops"], rec["bytes"]] == [1, flops, nbytes]
    assert (flops, nbytes) == (3 * 120, 5 * 120 * 4)
    assert ops.launch_counts() == launches
    ops.reset_shape_only()


def test_reverse_wrapper_refuses_what_the_kernel_cannot_take():
    """The reverse launch's wrapper takes three contiguous CUDA tensors of
    one shape and dtype, or raises; it never computes on the CPU."""
    x = torch.rand(2, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        scan_k.rglru_scan_backward(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        scan_k.rglru_scan_backward(x, x, torch.rand(2, 5, 8, device="meta"))
