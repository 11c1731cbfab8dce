"""The port's layers and attention against the JAX package, function by
function, on the same numpy inputs (fp32, atol 1e-5: both sides compute in
fp32 and differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import layers as jlay
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlay

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ATOL = 1e-5
D, H, KV, HD, THETA = 64, 4, 2, 16, 1e6


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_params(rng):
    return {
        "wq": _np(rng, (D, H * HD), D ** -0.5),
        "wk": _np(rng, (D, KV * HD), D ** -0.5),
        "wv": _np(rng, (D, KV * HD), D ** -0.5),
        "wo": _np(rng, (H * HD, D), (H * HD) ** -0.5),
    }


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err < atol, err


def test_rmsnorm_and_rms_normalize():
    rng = np.random.default_rng(0)
    x, scale = _np(rng, (2, 5, D)), _np(rng, (D,))
    _close(tlay.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jlay.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(tlay.rms_normalize(torch.from_numpy(x)),
           jlay.rms_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("start", [0, 500])
def test_apply_rope(start):
    rng = np.random.default_rng(1)
    x = _np(rng, (2, 48, H, HD))
    pos = (start + np.arange(48))[None, :].repeat(2, 0).astype(np.int32)
    _close(tlay.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), THETA),
           jlay.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA))


def test_mlp_apply_and_embed_lookup():
    rng = np.random.default_rng(2)
    p = {"w_gate": _np(rng, (D, 128), D ** -0.5), "w_up": _np(rng, (D, 128), D ** -0.5),
         "w_down": _np(rng, (128, D), 128 ** -0.5)}
    x = _np(rng, (2, 7, D))
    _close(tlay.mlp_apply(_t(p), torch.from_numpy(x)),
           jlay.mlp_apply(_j(p), jnp.asarray(x)))
    table, toks = _np(rng, (256, D)), rng.integers(0, 256, (2, 9))
    _close(tlay.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks)),
           jlay.embed_lookup(jnp.asarray(table), jnp.asarray(toks)))


@pytest.mark.parametrize("S,impl,jax_impl", [
    (64, "naive", "naive"),
    (64, "kernels", "chunked"),    # S <= 256: naive on both sides
    (300, "kernels", "chunked"),   # flash path (its plain version on CPU)
    (300, "naive", "chunked"),
])
def test_attn_apply(S, impl, jax_impl):
    rng = np.random.default_rng(3 + S)
    p, x = _attn_params(rng), _np(rng, (2, S, D))
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA, causal=True,
              qk_norm=True, return_kv=True)
    y, (k, v) = tatt.attn_apply(_t(p), torch.from_numpy(x), impl=impl, **kw)
    yj, (kj, vj) = jatt.attn_apply(_j(p), jnp.asarray(x), impl=jax_impl, **kw)
    _close(y, yj)
    _close(k, kj)
    _close(v, vj)


def test_attn_apply_rejects_unknown_impl():
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="impl"):
        tatt.attn_apply(_t(_attn_params(rng)), torch.zeros(1, 4, D), n_heads=H,
                        n_kv=KV, head_dim=HD, rope_theta=THETA, impl="pallas")


def _paged_state(rng, B=4, n_pp=3, ps=4, P=14):
    """Pools plus a table with distinct non-contiguous pages, one zeroed
    (trash-only) row, and positions that include a stale row whose
    position reaches n_pp*ps — its write must be dropped."""
    kp, vp = _np(rng, (P, KV, ps, HD)), _np(rng, (P, KV, ps, HD))
    table = np.asarray([[5, 2, 9], [1, 7, 0], [0, 0, 0], [3, 11, 4]], np.int32)
    pos = np.asarray([9, 4, 6, n_pp * ps], np.int32)
    return kp, vp, table, pos


def _scatter(pool, table, pos, vals):
    slots = tatt.page_slots(torch.from_numpy(table), torch.from_numpy(pos),
                            pool.shape[2])
    return tatt.paged_scatter(pool, slots, torch.from_numpy(vals))


# The trash page 0 takes every write that must land nowhere (zeroed table
# rows, and positions past the table, which JAX drops); its contents are
# unspecified, so the tests below hold the MAPPED pages (1:) to JAX.


def test_paged_gather_and_scatter_drop_out_of_range_writes():
    rng = np.random.default_rng(5)
    kp, _, table, pos = _paged_state(rng)
    vals = _np(rng, (4, KV, HD))
    _close(tatt.paged_gather(torch.from_numpy(kp), torch.from_numpy(table)),
           jatt.paged_gather(jnp.asarray(kp), jnp.asarray(table)))
    want = np.asarray(jatt.paged_scatter(jnp.asarray(kp), jnp.asarray(table),
                                         jnp.asarray(pos), jnp.asarray(vals)))
    pool = _scatter(torch.from_numpy(kp.copy()), table, pos, vals)
    np.testing.assert_array_equal(pool.numpy()[1:], want[1:])
    # the stale row (pos == n_pp*ps) changed no mapped page: only the
    # (page, offset) slots of rows 0 and 1 did (row 2 wrote the trash)
    changed = {tuple(int(i) for i in pair) for pair in
               np.argwhere(np.any(pool.numpy() != kp, axis=(1, 3)))}
    assert {pg_off for pg_off in changed if pg_off[0] != 0} == {(9, 1), (7, 0)}


def test_paged_scatter_with_every_row_out_of_range_is_a_no_op():
    rng = np.random.default_rng(6)
    kp, _, table, _ = _paged_state(rng)
    pos = np.full((4,), 12, np.int32)
    pool = _scatter(torch.from_numpy(kp.copy()), table, pos,
                    _np(rng, (4, KV, HD)))
    np.testing.assert_array_equal(pool.numpy()[1:], kp[1:])


@pytest.mark.parametrize("impl", ["naive", "kernels"])
def test_attn_decode_paged_matches_jax(impl):
    rng = np.random.default_rng(7)
    p = _attn_params(rng)
    kp, vp, table, pos = _paged_state(rng)
    x = _np(rng, (4, 1, D))
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA, qk_norm=True)
    yj, kj, vj = jatt.attn_decode(
        _j(p), jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pos), page_table=jnp.asarray(table), impl="ref", **kw)
    ck, cv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    y, ck2, cv2 = tatt.attn_decode(
        _t(p), torch.from_numpy(x), ck, cv, torch.from_numpy(pos),
        page_table=torch.from_numpy(table), impl=impl, **kw)
    assert ck2 is ck and cv2 is cv, "pools are updated in place"
    # row 2 has a zeroed table: a freed slot, whose output reads only the
    # trash page and is discarded by the batcher
    live = [0, 1, 3]
    _close(y[live], np.asarray(yj)[live])
    assert bool(torch.isfinite(y).all())
    _close(ck[1:], np.asarray(kj)[1:])
    _close(cv[1:], np.asarray(vj)[1:])


def test_attn_decode_requires_a_page_table():
    """Full-attention slab decode is ported: without a page table the
    slab path runs (no kernel), equal to JAX's slab branch, the new K/V
    written in place at each row's position, the stale row's (pos == S)
    clamped to the last position as JAX's ``dynamic_update_slice``."""
    rng = np.random.default_rng(8)
    p = _attn_params(rng)
    x = _np(rng, (3, 1, D))
    ck, cv = _np(rng, (3, KV, 8, HD)), _np(rng, (3, KV, 8, HD))
    pos = np.asarray([3, 0, 8], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA)
    yj, kj, vj = jatt.attn_decode(_j(p), jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(pos), **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    y, k2, v2 = tatt.attn_decode(_t(p), torch.from_numpy(x), tk, tv,
                                 torch.from_numpy(pos), impl="kernels", **kw)
    assert k2 is tk and v2 is tv
    _close(y, yj)
    _close(tk, kj)
    _close(tv, vj)


# ------------------------------------------------------- sliding window


@pytest.mark.parametrize("S,window,q_chunk", [(64, 16, 512), (96, 16, 24),
                                              (100, 16, 24), (300, 64, 512)])
def test_naive_and_local_attention_with_a_window(S, window, q_chunk):
    """Both windowed paths against JAX's naive one, and the local path
    with several q chunks against JAX's local one where the chunks tile S.
    With a ragged last chunk (S = 100 in chunks of 24) the JAX
    ``local_attention`` clamps that chunk's key slice at the end of the
    padded keys and scores its queries against shifted positions (a fault
    of the reference, ROADMAP queue 3); the port's chunks see the keys the
    window defines, so it is held to the naive path there."""
    rng = np.random.default_rng(10 + S)
    q, k, v = (_np(rng, (2, S, H, HD)) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jatt.naive_attention(jq, jk, jv, causal=True, window=window)
    _close(tatt.naive_attention(tq, tk, tv, causal=True, window=window), want)
    local = tatt.local_attention(tq, tk, tv, window=window, q_chunk=q_chunk)
    _close(local, want)
    if S % min(q_chunk, S) == 0:
        _close(local, jatt.local_attention(jq, jk, jv, window=window,
                                           q_chunk=q_chunk))


@pytest.mark.parametrize("S,impl,jax_impl", [
    (64, "naive", "naive"),
    (64, "kernels", "chunked"),    # S <= 256: naive with the window
    (300, "kernels", "chunked"),   # local_attention on both sides
    (300, "naive", "naive"),
])
def test_attn_apply_with_a_window(S, impl, jax_impl):
    """``attn_apply(window=...)`` dispatches as JAX does: never the flash
    kernel for a window, local attention past 256 tokens."""
    rng = np.random.default_rng(20 + S)
    p, x = _attn_params(rng), _np(rng, (2, S, D))
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4, causal=True,
              window=48, return_kv=True)
    y, (k, v) = tatt.attn_apply(_t(p), torch.from_numpy(x), impl=impl, **kw)
    yj, (kj, vj) = jatt.attn_apply(_j(p), jnp.asarray(x), impl=jax_impl, **kw)
    _close(y, yj)
    _close(k, kj)


def _slab_decode(p, x, ck, cv, pos, window, side):
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=1e4, window=window)
    if side == "jax":
        return jatt.attn_decode(_j(p), jnp.asarray(x), ck, cv,
                                jnp.asarray(pos), **kw)
    return tatt.attn_decode(_t(p), torch.from_numpy(x), ck, cv,
                            torch.from_numpy(pos), impl="kernels", **kw)


def test_attn_decode_circular_buffer_matches_jax_past_the_wrap():
    """A local layer's slab decode: rows at different depths write their
    token at ``pos % W`` and attend the last min(pos+1, W) tokens; twelve
    steps take every row past the wrap of its W = 8 buffer."""
    rng = np.random.default_rng(30)
    p, W = _attn_params(rng), 8
    ck0, cv0 = _np(rng, (3, KV, W, HD)), _np(rng, (3, KV, W, HD))
    jk, jv = jnp.asarray(ck0), jnp.asarray(cv0)
    tk, tv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    pos = np.asarray([0, 5, 13], np.int32)
    for _ in range(12):
        x = _np(rng, (3, 1, D))
        yj, jk, jv = _slab_decode(p, x, jk, jv, pos, W, "jax")
        y, tk2, tv2 = _slab_decode(p, x, tk, tv, pos, W, "port")
        assert tk2 is tk and tv2 is tv, "the buffers are updated in place"
        _close(y, yj)
        _close(tk, jk)
        _close(tv, jv)
        pos = pos + 1


def test_attn_decode_stale_row_at_pos_w_stays_in_its_own_row():
    """cache_len (= W = 6) below the window (8): a freed slot's stale row
    sits at pos == W.  JAX clamps that write to W-1; the port writes at
    pos % W = 0 without indexing past the buffer.  Either way only the
    stale row's own buffer changes, and live rows match JAX exactly."""
    rng = np.random.default_rng(31)
    p, W = _attn_params(rng), 6
    ck0, cv0 = _np(rng, (3, KV, W, HD)), _np(rng, (3, KV, W, HD))
    pos = np.asarray([2, 5, W], np.int32)
    x = _np(rng, (3, 1, D))
    yj, jk, _ = _slab_decode(p, x, jnp.asarray(ck0), jnp.asarray(cv0), pos,
                             8, "jax")
    tk = torch.from_numpy(ck0.copy())
    y, _, _ = _slab_decode(p, x, tk, torch.from_numpy(cv0.copy()), pos, 8,
                           "port")
    _close(y[:2], np.asarray(yj)[:2])
    _close(tk[:2], np.asarray(jk)[:2])
    changed = np.any(tk.numpy()[2] != ck0[2], axis=(0, 2))
    assert changed.tolist() == [True] + [False] * (W - 1)
    assert bool(torch.isfinite(y).all())


# ------------------------------------------------- chunked and cross paths

CHUNKED_ATOL = 2e-5  # tests/test_decode_equivalence.py::test_attention_impls_agree


@pytest.mark.parametrize("Sq,Sk,causal,q_offset,chunks", [
    (96, 96, True, 0, (32, 32)),     # test_attention_impls_agree's case
    (150, 300, False, 0, (64, 128)),  # Sq != Sk, ragged tails of both
    (150, 300, True, 150, (64, 128)),  # a q_offset (chunked prefill)
    (70, 200, True, 0, (64, 128)),    # top-left: blocks past the diagonal
    (520, 1030, False, 0, (512, 1024)),  # the defaults, ragged past both
    (520, 520, True, 0, (512, 1024)),
])
def test_chunked_attention_matches_jax(Sq, Sk, causal, q_offset, chunks):
    rng = np.random.default_rng(Sq + Sk)
    q = _np(rng, (1, Sq, H, HD))
    k, v = _np(rng, (1, Sk, H, HD)), _np(rng, (1, Sk, H, HD))
    kw = dict(causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1],
              q_offset=q_offset)
    got = tatt.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw)
    want = jatt.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(got, want, CHUNKED_ATOL)
    ref = tatt.naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, q_offset=q_offset)
    _close(got, ref.numpy(), CHUNKED_ATOL)


def test_attn_apply_chunked_impl_matches_jax():
    """``impl="chunked"`` (the kernels-off decoder's) takes
    ``chunked_attention`` past 256 tokens, as JAX's default does."""
    rng = np.random.default_rng(40)
    p, x = _attn_params(rng), _np(rng, (2, 300, D))
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA, causal=True,
              qk_norm=True)
    _close(tatt.attn_apply(_t(p), torch.from_numpy(x), impl="chunked", **kw),
           jatt.attn_apply(_j(p), jnp.asarray(x), impl="chunked", **kw))


def _memory(rng, B, E):
    mem = _np(rng, (B, E, D))
    p = _attn_params(rng)
    mk = (mem @ p["wk"]).reshape(B, E, KV, HD)
    mv = (mem @ p["wv"]).reshape(B, E, KV, HD)
    return p, mk, mv


@pytest.mark.parametrize("S,E,impl", [(12, 20, "chunked"), (300, 280, "chunked"),
                                      (300, 280, "kernels"), (12, 300, "kernels")])
def test_attn_apply_kv_override_matches_jax(S, E, impl):
    """Cross-attention: k/v come in as given (no projection, norm or RoPE);
    q is rotated only when ``rope_theta > 0``."""
    rng = np.random.default_rng(41 + S)
    p, mk, mv = _memory(rng, 2, E)
    x = _np(rng, (2, S, D))
    for theta in (0.0, THETA):
        kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=theta,
                  causal=False)
        got = tatt.attn_apply(_t(p), torch.from_numpy(x), impl=impl,
                              kv_override=(torch.from_numpy(mk),
                                           torch.from_numpy(mv)), **kw)
        want = jatt.attn_apply(_j(p), jnp.asarray(x), impl="chunked",
                               kv_override=(jnp.asarray(mk), jnp.asarray(mv)),
                               **kw)
        _close(got, want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross_len", [None, 13])
def test_attn_decode_cross_matches_jax(cache_dtype, cross_len):
    """Decode over a fixed slot-major memory: no cache write, no RoPE on q,
    keys below ``cross_len`` valid; with a bf16 memory the attention
    weights are rounded to bf16, as JAX rounds them."""
    rng = np.random.default_rng(42)
    p, mk, mv = _memory(rng, 3, 20)
    ck = mk.transpose(0, 2, 1, 3)
    cv = mv.transpose(0, 2, 1, 3)
    jdt = jnp.dtype(cache_dtype)
    tdt = getattr(torch, cache_dtype)
    x = _np(rng, (3, 1, D))
    pos = np.asarray([4, 0, 17], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA, cross=True,
              cross_len=cross_len)
    yj, kj, _ = jatt.attn_decode(_j(p), jnp.asarray(x),
                                 jnp.asarray(ck).astype(jdt),
                                 jnp.asarray(cv).astype(jdt),
                                 jnp.asarray(pos), **kw)
    tk = torch.from_numpy(np.ascontiguousarray(ck)).to(tdt)
    tv = torch.from_numpy(np.ascontiguousarray(cv)).to(tdt)
    before = tk.clone()
    y, tk2, _ = tatt.attn_decode(_t(p), torch.from_numpy(x), tk, tv,
                                 torch.from_numpy(pos), impl="kernels", **kw)
    assert tk2 is tk and torch.equal(tk, before), "the memory is read-only"
    _close(y, yj)
    with pytest.raises(ValueError, match="paged"):
        tatt.attn_decode(_t(p), torch.from_numpy(x), tk, tv, 0,
                         page_table=torch.zeros((3, 2), dtype=torch.int32),
                         **kw)
