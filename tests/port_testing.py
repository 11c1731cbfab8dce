"""What the port's CPU tests share: two module fixtures, which a module
takes by importing them (a fixture in a module's namespace is that
module's), and the JAX reference of a request decoded alone."""

import jax
import jax.numpy as jnp
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (restored after): its
    small CPU ops gain nothing from more, and under parallel test workers
    every op's thread team would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def unoptimized_jax():
    """The module's JAX references compile with most XLA optimizations off
    (``jax_disable_most_optimizations``: backend optimization level 0, no
    expensive LLVM passes), as the port's JAX subprocesses compile through
    ``XLA_FLAGS``: the programs are small, so compiling them costs more
    than running them.  The programs compute the same functions.  On
    leaving, the flag is restored and every compiled program dropped, so
    no later module runs one built under it."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
    jax.clear_caches()


#: id of a JAX model → (the model, which keeps the id from being reused,
#: its jitted prefill, its jitted decode step): an eager decode step
#: compiles each op anew (a 14-request trace took ~100 s)
_JITTED = {}


def jax_solo_tokens(jmodel, params, tokens, max_new, *, cache_len,
                    cache_dtype):
    """JAX reference: the greedy tokens of a request decoded entirely
    alone (batch 1, slab cache), its prefill and decode step jitted."""
    if id(jmodel) not in _JITTED:
        _JITTED[id(jmodel)] = (
            jmodel,
            jax.jit(jmodel.prefill, static_argnames=("cache_len",
                                                     "cache_dtype")),
            jax.jit(jmodel.decode_step))
    _, prefill, decode_step = _JITTED[id(jmodel)]
    logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)[None]},
                            cache_len=cache_len,
                            cache_dtype=jnp.dtype(cache_dtype))
    out = [int(jnp.argmax(logits[0], axis=-1))]
    for i in range(max_new - 1):
        logits, cache = decode_step(
            params, jnp.asarray([out[-1]], jnp.int32), cache, len(tokens) + i)
        out.append(int(jnp.argmax(logits[0], axis=-1)))
    return out
