"""The port's VLM path (pixtral family: stub patch embeddings prepended to
the token stream) against the JAX one.

Reduced pixtral-12b (``reduced()``: 2 layers, d 64, GQA 4:1, hd 16, a
16-position stub) in fp32, params initialized once in JAX and handed to
both packages through ``repro_torch.bridge``.  The stub shifts every
position: RoPE runs over stub and text, the first decode position is P +
prompt, and the loss drops the first P positions.  A port that is off by
one there matches the first token and drifts after it, so every decode
step's logits and token are held, not the first alone.  Tolerances are the
reference's own (1e-4 on logits and caches, 1e-5 on gradients, 5e-4 for
decode against the parallel forward); the JAX side is ``jax.jit``-ed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serving.batcher import _write_pages_impl
from repro_torch import bridge
from repro_torch.config import ShardingConfig, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving.batcher import write_pages

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401


ARCH = "pixtral-12b"
ATOL = 1e-4
PS = 8
P = 16  # the reduced config's frontend_stub_len


@pytest.fixture(scope="module")
def jax_side():
    model = jax_build_model(jax_reduced(jax_get_arch(ARCH)))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    fns = dict(
        prefill=jax.jit(model.prefill, static_argnames=("cache_len",
                                                         "cache_dtype")),
        decode=jax.jit(model.decode_step),
        loss=jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0])),
    )
    return model, params, jax.tree.map(np.asarray, params), fns


def _port(np_params, use_kernels, *, train=False):
    model = build_model(reduced(get_arch(ARCH)),
                        ShardingConfig(use_kernels=use_kernels),
                        device="cpu", train=train)
    return bridge.load_jax_params(model, np_params)


def _inputs(seed, B, S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, S)).astype(np.int32),
            rng.standard_normal((B, P, 64)).astype(np.float32))


def _err(got, want):
    return float(np.max(np.abs(got.detach().numpy() - np.asarray(want))))


def test_reduced_config_keeps_the_stub_and_gqa():
    cfg = reduced(get_arch(ARCH))
    assert (cfg.family, cfg.frontend_stub_len, cfg.n_heads, cfg.n_kv_heads,
            cfg.n_layers) == ("vlm", P, 4, 1, 2)
    model = build_model(cfg, device="cpu")
    assert type(model.impl).__name__ == "Transformer"
    assert model.supports_chunked_prefill


@pytest.mark.parametrize("S,use_kernels", [(12, False), (12, True),
                                           (300, False), (300, True)])
def test_prefill_with_embeds_logits_and_cache(jax_side, S, use_kernels):
    """P + S positions: 28 (naive) and 316 (chunked, or the flash
    kernel's plain version)."""
    _, params, np_params, fns = jax_side
    toks, emb = _inputs(S, 2, S)
    cache_len = P + S + 8
    lj, cj = fns["prefill"](params, {"tokens": jnp.asarray(toks),
                                     "embeds": jnp.asarray(emb)},
                            cache_len=cache_len, cache_dtype=jnp.float32)
    lt, ct = _port(np_params, use_kernels).prefill(
        {"tokens": torch.from_numpy(toks).long(),
         "embeds": torch.from_numpy(emb)},
        cache_len=cache_len, cache_dtype=torch.float32)
    assert _err(lt, lj) < ATOL
    for i, layer in enumerate(ct):
        for key in ("k", "v"):
            want = np.asarray(cj["groups"]["p0"][key][i])
            assert tuple(layer[key].shape) == want.shape
            assert _err(layer[key], want) < ATOL, (i, key)


@pytest.mark.parametrize("S,use_kernels", [(9, False), (9, True),
                                           (260, True)])
def test_paged_decode_every_step_and_token(jax_side, S, use_kernels):
    """Prefill with embeds, map into page pools, then six decode steps
    from position P + S: each step's logits and greedy token."""
    jmodel, params, np_params, fns = jax_side
    model = _port(np_params, use_kernels)
    B, steps = 2, 6
    cache_len = P + S + steps + 2
    n_pp = -(-cache_len // PS)
    rows = (1 + np.arange(B * n_pp).reshape(B, n_pp)[:, ::-1]).astype(np.int32)
    toks, emb = _inputs(S + 1, B, S)
    lj, pj = fns["prefill"](params, {"tokens": jnp.asarray(toks),
                                     "embeds": jnp.asarray(emb)},
                            cache_len=cache_len, cache_dtype=jnp.float32)
    cj, layout = jmodel.init_paged_cache(B, cache_len, n_pages=B * n_pp + 1,
                                         page_size=PS,
                                         cache_dtype=jnp.float32)
    cj = _write_pages_impl(cj, pj, jnp.arange(B), jnp.asarray(rows), layout)
    lt, pt = model.prefill({"tokens": torch.from_numpy(toks).long(),
                            "embeds": torch.from_numpy(emb)},
                           cache_len=cache_len, cache_dtype=torch.float32)
    ct, lay = model.init_paged_cache(B, cache_len, n_pages=B * n_pp + 1,
                                     page_size=PS, cache_dtype=torch.float32)
    write_pages(ct, pt, np.arange(B), rows, lay)
    table = torch.from_numpy(rows)
    tok_j = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    tok_t = lt.argmax(dim=-1).numpy().astype(np.int32)
    for step in range(steps):
        assert (tok_t == tok_j).all(), step
        pos = np.full((B,), P + S + step, np.int32)
        lj, cj = fns["decode"](params, jnp.asarray(tok_j), cj,
                               jnp.asarray(pos), pages=jnp.asarray(rows))
        lt, ct = model.decode_step(torch.from_numpy(tok_t).long(), ct,
                                   torch.from_numpy(pos), pages=table)
        assert _err(lt, lj) < ATOL, step
        tok_j = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
        tok_t = lt.argmax(dim=-1).numpy().astype(np.int32)
    assert (tok_t == tok_j).all()


def test_decode_matches_own_forward_past_the_stub(jax_side):
    """Prefill the stub and 5 tokens, decode the rest; each step's logits
    equal the parallel forward's at P + t (< 5e-4)."""
    model = _port(jax_side[2], True)
    impl = model.impl
    B, T, T0 = 2, 10, 5
    toks, emb = _inputs(3, B, T)
    tt, ee = torch.from_numpy(toks).long(), torch.from_numpy(emb)
    h, _ = impl.forward(tt, ee)
    ref = (h @ impl.head()).float()
    lg, pc = model.prefill({"tokens": tt[:, :T0], "embeds": ee},
                           cache_len=P + T, cache_dtype=torch.float32)
    assert float((lg - ref[:, P + T0 - 1]).abs().max()) < 5e-4
    n_pp = -(-(P + T) // PS)
    rows = (1 + np.arange(B * n_pp).reshape(B, n_pp)).astype(np.int32)
    cache, lay = model.init_paged_cache(B, P + T, n_pages=B * n_pp + 1,
                                        page_size=PS,
                                        cache_dtype=torch.float32)
    write_pages(cache, pc, np.arange(B), rows, lay)
    for t in range(T0, T):
        lg, cache = model.decode_step(tt[:, t], cache, P + t,
                                      pages=torch.from_numpy(rows))
        assert float((lg - ref[:, P + t]).abs().max()) < 5e-4, t


@pytest.mark.parametrize("S,use_kernels", [(24, False), (300, True)])
def test_loss_with_embeds_and_grads_match_jax(jax_side, S, use_kernels):
    """Labels cover the text only: the loss drops the first P positions of
    the hidden states.  Loss and every gradient leaf against ``jax.grad``
    (the stub's embeddings take no gradient: they are inputs)."""
    _, params, np_params, fns = jax_side
    toks, emb = _inputs(S + 2, 2, S)
    labels = np.roll(toks, -1, axis=1)
    batch = dict(tokens=toks, embeds=emb, labels=labels)
    l_jax, g_jax = fns["loss"](params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    model = _port(np_params, use_kernels, train=True)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(l_jax)) < ATOL
    named = list(model.impl.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want = bridge.from_jax(jax.tree.map(np.asarray, g_jax), model.cfg)
    for (name, _), g in zip(named, grads):
        assert _err(g, want[name]) < 1e-5, name
