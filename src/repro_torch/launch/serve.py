"""Serving driver: a thin shell over the queue-driven ServingSession (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 512 --gen-len 32            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --prompt-len 512 --gen-len 32                         # MoE, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --prompt-len 512 --gen-len 32  # hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-medium --prompt-len 512 --enc-len 1024  # enc-dec
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
        --prompt-len 512 --stub-len 1024                      # VLM, one image
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --prompt-len 512 --gen-len 32                         # ssm
    PYTHONPATH=src python -m repro_torch.launch.serve --slab \\
        --prompt-len 512 --gen-len 32                         # slab KV
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --prefix-smoke --shared-prefix 16 --prefill-chunk 8 --page-size 8

Requests are random prompts from ``numpy.random.default_rng(seed + 1)``
(``--shared-prefix N`` gives them all the same first N tokens, drawn from
the same generator after the prompts); the weights are random from
``seed``.  Encoder-decoder requests carry ``frames`` of (``--enc-len``,
d) and VLM requests ``embeds`` of (``--stub-len``, d), random normals
from the same generator; by default ``enc_len = max(prompt_len // 4, 1)``
and the stub is ``min(frontend_stub_len, 8)`` positions, which
``cache_len`` counts, as the JAX CLI has them.  KV memory is the paged
layout (``--slab`` gives each slot its own ``cache_len`` slab instead),
admission prefills are stacked per prompt length (``--no-batched-prefill`` restores batch-1 joins),
``--prefill-chunk N`` streams long prompts into the page pool in N-token
chunks interleaved with decode steps (``--prefill-duty`` sets the
chunk:decode duty cycle), ``--prefix-sharing`` maps hot prompt prefixes
through the radix index, ``--kv-admission grow`` maps pages as decode
writes them, and ``--static`` switches to drain-then-refill batching.  The
session replans on every shift of the request mix (``replan="mix"``);
``--no-replan`` plans the first mix only.  ``--prefix-smoke`` serves one
shared-prefix trace with and without sharing and fails unless sharing
hit, shrank the KV high-water and left every token as it was.  Runs on
the GPU unless ``--device cpu`` is given (``cuda`` without a GPU raises).
Exits non-zero when no output tokens were generated.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ArchConfig, get_arch
from ..serving import Request, ServingConfig, ServingSession


def frontend_lens(cfg: ArchConfig, prompt_len: int, enc_len: int = 0,
                  stub_len: int = 0):
    """(frames per request, stub positions per request) of ``cfg``: the
    encoder memory length of an enc-dec arch (``enc_len``, 0 → ``max(
    prompt_len // 4, 1)``) and a VLM's patch count (``stub_len``, 0 →
    ``min(frontend_stub_len, 8)``); 0 where the arch takes none."""
    enc = (enc_len or max(prompt_len // 4, 1)) if cfg.is_encdec else 0
    stub = ((stub_len or min(cfg.frontend_stub_len, 8))
            if cfg.family == "vlm" else 0)
    return enc, stub


def _build_requests(cfg: ArchConfig, *, n_requests: int, prompt_len: int,
                    gen_len: int, seed: int, arrival_every: float,
                    shared_prefix: int = 0, enc_len: int = 0,
                    stub_len: int = 0) -> list:
    """Random prompts, and each request's stub modality inputs: ``frames``
    (``enc_len``, d) for an enc-dec ``cfg``, ``embeds`` (``stub_len``, d)
    for a VLM (see :func:`frontend_lens`)."""
    rng = np.random.default_rng(seed + 1)
    vocab = cfg.vocab
    prompts = [rng.integers(0, vocab, size=(prompt_len,), dtype=np.int64)
               for _ in range(n_requests)]
    if shared_prefix:
        # every request opens with the same system-prompt-like prefix and
        # diverges into a private suffix — the prefix-sharing workload
        prefix = rng.integers(0, vocab, size=(shared_prefix,), dtype=np.int64)
        prompts = [np.concatenate([prefix, p[shared_prefix:]])
                   for p in prompts]
    enc, stub = frontend_lens(cfg, prompt_len, enc_len, stub_len)
    reqs = []
    for i, toks in enumerate(prompts):
        extras = {}
        if enc:
            extras["frames"] = rng.standard_normal(
                (enc, cfg.d_model), dtype=np.float32)
        elif stub:
            extras["embeds"] = rng.standard_normal(
                (stub, cfg.d_model), dtype=np.float32)
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=gen_len,
                            arrival=i * arrival_every, extras=extras))
    return reqs


def serve(
    arch: str = "qwen3-0.6b",
    *,
    reduced_cfg: bool = True,
    n_requests: int = 8,
    prompt_len: int = 32,
    gen_len: int = 16,
    seed: int = 0,
    verbose: bool = True,
    max_slots: Optional[int] = None,
    admission: str = "continuous",
    replan: str = "mix",
    arrival_every: float = 0.0,
    page_size: int = 16,
    kv_pages: int = 0,
    prefill_chunk: int = 0,
    prefill_duty: float = 1.0,
    batched_prefill: bool = True,
    prefix_sharing: bool = False,
    kv_admission: str = "reserve",
    shared_prefix: int = 0,
    kv_layout: str = "paged",
    cache_dtype: str = "bfloat16",
    device: str = "cuda",
    enc_len: int = 0,
    stub_len: int = 0,
    model: Any = None,
) -> Dict[str, Any]:
    """Serve ``n_requests`` random prompts; returns tokens + metrics
    (``init_seconds``: building and initializing the model).  ``enc_len``
    and ``stub_len`` size the enc-dec frames and the VLM patch embeddings
    (:func:`frontend_lens`).  ``model``: an already built model of
    ``arch`` to serve as it is (``ServingSession``'s ``model``), so that
    several runs share one set of weights."""
    enc, stub = frontend_lens(get_arch(arch), prompt_len, enc_len, stub_len)
    t_init = time.perf_counter()
    session = ServingSession(
        ServingConfig(
            arch=arch,
            reduced_cfg=reduced_cfg,
            seed=seed,
            device=device,
            max_slots=max_slots or n_requests,
            cache_len=prompt_len + stub + gen_len,
            enc_len=enc,
            admission=admission,
            replan=replan,
            page_size=page_size,
            kv_pages=kv_pages,
            prefill_chunk=prefill_chunk,
            prefill_duty=prefill_duty,
            batched_prefill=batched_prefill,
            prefix_sharing=prefix_sharing,
            kv_admission=kv_admission,
            kv_layout=kv_layout,
            cache_dtype=cache_dtype,
        ),
        model=model,
    )
    init_seconds = time.perf_counter() - t_init
    reqs = _build_requests(
        session.model.cfg, n_requests=n_requests,
        prompt_len=prompt_len, gen_len=gen_len, seed=seed,
        arrival_every=arrival_every, shared_prefix=shared_prefix,
        enc_len=enc, stub_len=stub,
    )
    t0 = time.perf_counter()
    metrics = session.run(reqs)
    wall = time.perf_counter() - t0
    # rejected (admission control) or cut-off requests have no result row
    done = [session.results[r.rid].tokens for r in reqs
            if r.rid in session.results]
    out_tokens = (torch.tensor(done, dtype=torch.long) if done
                  else torch.zeros((0, gen_len), dtype=torch.long))
    if verbose:
        b = session.batcher
        tps = metrics["output_tokens"] / max(b.decode_seconds, 1e-9)
        print(
            f"[serve] {arch}: {metrics['requests']} requests ({admission} "
            f"batching, replan={replan}) on {session.device} in "
            f"{wall * 1e3:.0f} ms; {b.decode_steps} decode steps at "
            f"{tps:.0f} tok/s; {metrics['replans']} replans "
            f"{metrics['replan_modes']} (model init {init_seconds:.1f} s)"
        )
        print(f"[serve] prefill: {metrics['prefill_calls']} calls "
              f"({b.chunk_steps} chunk steps, {b.interleaved_chunks} "
              f"interleaved with decode) in {metrics['prefill_seconds']:.4f}"
              f" s; decode {metrics['decode_seconds']:.4f} s")
        if metrics.get("kv_page_hw") is not None:  # a page pool ran
            print(
                f"[serve] kv pages: high-water "
                f"{metrics['kv_page_hw_tokens']} tokens over a "
                f"{metrics['kv_slab_tokens']}-token slab footprint "
                f"({100 * metrics['kv_mem_saving']:.0f}% saved)"
            )
        if metrics.get("prefix_sharing"):
            print(
                f"[serve] prefix sharing: prefix_hit_rate="
                f"{metrics['prefix_hit_rate']:.3f} "
                f"({metrics['prefix_hits']}/{metrics['prefix_requests']} "
                f"requests, {metrics['prefix_hit_tokens']} tokens mapped); "
                f"kv_compression={metrics['kv_compression']:.2f}x, "
                f"{metrics['kv_shared_maps']} shared maps, "
                f"{metrics['kv_cow_forks']} cow forks"
            )
        if metrics.get("kv_admission") == "grow":
            print(
                f"[serve] grow admission: {metrics['kv_grow_allocs']} "
                f"pages grown, {metrics['kv_grow_defers']} paused steps, "
                f"{metrics['kv_preemptions']} preemptions"
            )
        sample = out_tokens[0][:12].tolist() if len(done) else []
        print(f"[serve] generated {metrics['output_tokens']} tokens; "
              f"sample: {sample}")
    return {"arch": arch, "tokens": out_tokens, "init_seconds": init_seconds,
            **metrics}


def prefix_smoke(args) -> int:
    """Serve one shared-prefix trace twice — shared (grow admission) and the
    unshared paged baseline — and fail unless sharing actually hit
    (``prefix_hit_rate > 0``), its KV high-water came in strictly below the
    unshared run, and the generated tokens are EXACTLY the baseline's (an
    fp32 cache pins the arithmetic)."""
    common = dict(
        reduced_cfg=args.reduced,
        n_requests=args.requests,
        prompt_len=args.prompt_len,
        gen_len=args.gen_len,
        seed=args.seed,
        max_slots=args.slots or None,
        replan="off",
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        shared_prefix=args.shared_prefix,
        cache_dtype="float32",
        device=args.device,
    )
    base = serve(args.arch, **common)
    shared = serve(args.arch, prefix_sharing=True, kv_admission="grow",
                   **common)
    exact = torch.equal(base["tokens"], shared["tokens"])
    hit = shared.get("prefix_hit_rate", 0.0)
    hw_base, hw_shared = base["kv_page_hw"], shared["kv_page_hw"]
    print(
        f"[prefix-smoke] prefix_hit_rate={hit:.3f} "
        f"kv_page_hw shared={hw_shared} unshared={hw_base} "
        f"token_exact={exact}"
    )
    ok = exact and hit > 0 and hw_shared < hw_base
    print(f"[prefix-smoke] {'PASSED' if ok else 'FAILED'}")
    return 0 if ok else 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=0,
                    help="batch slots (default: --requests)")
    ap.add_argument("--arrival-every", type=float, default=0.0,
                    help="stagger arrivals by N decode steps")
    ap.add_argument("--static", action="store_true",
                    help="classic drain-then-refill batching")
    ap.add_argument("--no-replan", action="store_true",
                    help="serve on the initial plan only")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in token positions")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="physical page budget (0 = full coverage)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk long prompts into N-token prefill chunks "
                         "interleaved with decode (0 = one-shot)")
    ap.add_argument("--prefill-duty", type=float, default=1.0,
                    help="prefill chunks allowed per decode step")
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="batch-1 admission prefills")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="map hot prompt prefixes through the radix index "
                         "instead of re-prefilling them")
    ap.add_argument("--kv-admission", choices=("reserve", "grow"),
                    default="reserve",
                    help="page admission: reserve the full reach up front, "
                         "or grow pages as decode writes them")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the same first N prompt tokens")
    ap.add_argument("--prefix-smoke", action="store_true",
                    help="serve a shared-prefix trace with and without "
                         "sharing; fail unless hits > 0, the KV high-water "
                         "shrinks, and tokens match exactly")
    ap.add_argument("--slab", action="store_true",
                    help="per-slot KV slabs instead of the page pool")
    ap.add_argument("--cache-dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain PyTorch)")
    ap.add_argument("--enc-len", type=int, default=0,
                    help="enc-dec archs: frames per request (0 = prompt "
                         "length // 4)")
    ap.add_argument("--stub-len", type=int, default=0,
                    help="VLM archs: patch embeddings per request (0 = "
                         "min(frontend_stub_len, 8))")
    args = ap.parse_args()
    if args.prefix_smoke:
        sys.exit(prefix_smoke(args))
    out = serve(
        args.arch,
        reduced_cfg=args.reduced,
        n_requests=args.requests,
        prompt_len=args.prompt_len,
        gen_len=args.gen_len,
        seed=args.seed,
        max_slots=args.slots or None,
        admission="static" if args.static else "continuous",
        replan="initial" if args.no_replan else "mix",
        arrival_every=args.arrival_every,
        page_size=args.page_size,
        kv_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk,
        prefill_duty=args.prefill_duty,
        batched_prefill=not args.no_batched_prefill,
        prefix_sharing=args.prefix_sharing,
        kv_admission=args.kv_admission,
        shared_prefix=args.shared_prefix,
        kv_layout="slab" if args.slab else "paged",
        cache_dtype=args.cache_dtype,
        device=args.device,
        enc_len=args.enc_len,
        stub_len=args.stub_len,
    )
    if out["output_tokens"] <= 0 or out["requests"] <= 0:
        print("[serve] FAILED: no output tokens generated", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
