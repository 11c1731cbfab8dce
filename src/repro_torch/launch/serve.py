"""Serving driver: a thin shell over the queue-driven ServingSession (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 8 --prompt-len 512 --gen-len 32            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --prompt-len 512 --gen-len 32                         # MoE, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-9b --prompt-len 512 --gen-len 32  # hybrid
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Requests are random prompts from ``numpy.random.default_rng(seed + 1)``;
the weights are random from ``seed``.  KV memory is the paged layout,
admission prefills are stacked per prompt length (``--no-batched-prefill``
restores batch-1 joins), and ``--static`` switches to drain-then-refill
batching.  The session replans on every shift of the request mix
(``replan="mix"``); ``--no-replan`` plans the first mix only.  Runs on the GPU unless ``--device cpu`` is given (``cuda``
without a GPU raises).  Exits non-zero when no output tokens were
generated.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..serving import Request, ServingConfig, ServingSession


def _build_requests(vocab: int, *, n_requests: int, prompt_len: int,
                    gen_len: int, seed: int, arrival_every: float) -> list:
    rng = np.random.default_rng(seed + 1)
    return [
        Request(
            rid=i,
            tokens=rng.integers(0, vocab, size=(prompt_len,), dtype=np.int64),
            max_new_tokens=gen_len,
            arrival=i * arrival_every,
        )
        for i in range(n_requests)
    ]


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
    batched_prefill: bool = True,
    cache_dtype: str = "bfloat16",
    device: str = "cuda",
) -> Dict[str, Any]:
    """Serve ``n_requests`` random prompts; returns tokens + metrics
    (``init_seconds``: building and initializing the model)."""
    t_init = time.perf_counter()
    session = ServingSession(
        ServingConfig(
            arch=arch,
            reduced_cfg=reduced_cfg,
            seed=seed,
            device=device,
            max_slots=max_slots or n_requests,
            cache_len=prompt_len + gen_len,
            admission=admission,
            replan=replan,
            page_size=page_size,
            kv_pages=kv_pages,
            batched_prefill=batched_prefill,
            cache_dtype=cache_dtype,
        )
    )
    init_seconds = time.perf_counter() - t_init
    reqs = _build_requests(
        session.model.cfg.vocab, n_requests=n_requests,
        prompt_len=prompt_len, gen_len=gen_len, seed=seed,
        arrival_every=arrival_every,
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
        print(f"[serve] prefill: {metrics['prefill_calls']} calls in "
              f"{metrics['prefill_seconds']:.4f} s; decode "
              f"{metrics['decode_seconds']:.4f} s")
        print(
            f"[serve] kv pages: high-water {metrics['kv_page_hw_tokens']} "
            f"tokens over a {metrics['kv_slab_tokens']}-token slab footprint "
            f"({100 * metrics['kv_mem_saving']:.0f}% saved)"
        )
        sample = out_tokens[0][:12].tolist() if len(done) else []
        print(f"[serve] generated {metrics['output_tokens']} tokens; "
              f"sample: {sample}")
    return {"arch": arch, "tokens": out_tokens, "init_seconds": init_seconds,
            **metrics}


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
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="batch-1 admission prefills")
    ap.add_argument("--cache-dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain PyTorch)")
    args = ap.parse_args()
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
        batched_prefill=not args.no_batched_prefill,
        cache_dtype=args.cache_dtype,
        device=args.device,
    )
    if out["output_tokens"] <= 0 or out["requests"] <= 0:
        print("[serve] FAILED: no output tokens generated", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
