#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only kernels

Phases, one summary line each (any failure exits non-zero, nothing is
caught):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and fp32: max error and tolerance, the
   kernel's time, the plain version's time, the bound (the least time the
   card could take: bytes over 3.35 TB/s or flops over the dtype's peak,
   whichever is larger) and one PyTorch library call as a yardstick
   (SDPA for flash; none exists for paged decode);
4. serve full-width, full-depth qwen3-0.6b (random weights from a seed):
   8 requests, prompt 512, 32 new tokens, 8 slots, page size 16, bf16
   cache, through ``repro_torch.launch.serve.serve``; the launch counters
   are zeroed just before and read just after, and flash launches must
   equal 28 x prefill calls, paged launches 28 x decode steps;
5. serve the reduced qwen3 in fp32 from one seed on ``cuda`` and on ``cpu``
   and require identical tokens (the kernels against the plain path);
6. print a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off tensor cores
# (rtol, atol): a kernel passes where |kernel - plain| <= atol + rtol*|plain|.
# Both compute in fp32 from the same inputs and round once to the output
# dtype, so in bf16 they may differ by one output ulp (at most 2^-7 of the
# value) on top of fp32 summation-order noise; 2e-4 is the JAX kernel
# tests' fp32 tolerance.
TOL = {"bfloat16": (2.0 ** -7, 2e-4), "float32": (0.0, 2e-4)}
TOL_TEXT = {"bfloat16": "2e-4 + 2^-7*|plain|", "float32": "2e-4"}
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:151"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:142"),
}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, cycling through
    ``arg_sets`` (copies whose total exceeds the 50 MB L2, so each launch
    finds its inputs cold, as a layer of the served model does)."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def check_close(what: str, got, want, dtype_name: str) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``TOL``."""
    rtol, atol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    worst = float((diff - rtol * want.float().abs()).max())
    if not worst <= atol:
        raise AssertionError(f"{what} {dtype_name}: max err {err} exceeds "
                             f"{TOL_TEXT[dtype_name]} (by {worst - atol})")
    return err


def n_copies(torch, per_copy_bytes: int) -> int:
    return max(2, math.ceil(64e6 / max(per_copy_bytes, 1)) + 1)


def check_paged(torch, ops, ref, dtype_name: str) -> dict:
    """Paged decode at the serving path's shapes: B=8, H=16, K=8, hd=128,
    ps=16, n_pp=34; ragged lengths, non-contiguous pages, all-trash tails."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(11)
    B, H, K, hd, ps, n_pp = 8, 16, 8, 128, 16, 34
    P = B * n_pp + 1
    lengths = torch.tensor([543, 530, 512, 400, 287, 100, 16, 0],
                           dtype=torch.int32)
    table = (torch.randperm(B * n_pp, generator=g) + 1).to(torch.int32)
    table = table.reshape(B, n_pp)
    for b in range(B):  # pages past the row's position are unmapped: trash
        table[b, int(lengths[b]) // ps + 1:] = 0
    table, lengths = table.to(dev), lengths.to(dev)

    def make():
        q = torch.randn(B, H, hd, generator=g).to(dev, dt)
        kp = torch.randn(P, K, ps, hd, generator=g).to(dev, dt)
        vp = torch.randn(P, K, ps, hd, generator=g).to(dev, dt)
        return q, kp, vp, table, lengths

    first = make()
    got = ops.paged_attention(*first)
    want = ref.paged_attention_ref(*first)
    err = check_close("paged_attention", got, want, dtype_name)
    itemsize = first[1].element_size()
    sets = [first] + [make() for _ in range(
        n_copies(torch, 2 * first[1].numel() * itemsize) - 1)]
    ms = time_ms(torch, ops.paged_attention, sets)
    plain_ms = time_ms(torch, ref.paged_attention_ref, sets, iters=10)
    live = sum(min(int(x) + 1, n_pp * ps) for x in lengths.tolist())
    nbytes = (2 * live * K * hd * itemsize + 2 * B * H * hd * itemsize
              + table.numel() * 4 + B * 4)
    flops = 4.0 * live * H * hd
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    return dict(max_abs_err=err, tol=TOL_TEXT[dtype_name], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=None)


def check_flash(torch, ops, ref, dtype_name: str, S: int) -> dict:
    """Causal flash forward at the prefill shapes: B=8, H=16, K=8, hd=128."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(12 + S)
    B, H, K, hd = 8, 16, 8, 128

    def make():
        q = torch.randn(B, H, S, hd, generator=g).to(dev, dt)
        k = torch.randn(B, K, S, hd, generator=g).to(dev, dt)
        v = torch.randn(B, K, S, hd, generator=g).to(dev, dt)
        return q, k, v

    first = make()
    got = ops.flash_attention(*first)
    want = ref.flash_attention_ref(*first)
    err = check_close(f"flash_attention S={S}", got, want, dtype_name)
    itemsize = first[0].element_size()
    per = (first[0].numel() + 2 * first[1].numel()) * itemsize
    sets = [first] + [make() for _ in range(n_copies(torch, per) - 1)]
    ms = time_ms(torch, ops.flash_attention, sets)
    plain_ms = time_ms(torch, ref.flash_attention_ref, sets, iters=10)
    # the yardstick: one PyTorch call (never used by the port); KV heads
    # repeated outside the timed call
    rsets = [(q, k.repeat_interleave(H // K, 1), v.repeat_interleave(H // K, 1))
             for q, k, v in sets]
    library_ms = time_ms(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), rsets)
    nbytes = 2 * first[0].numel() * itemsize + 2 * first[1].numel() * itemsize
    flops = 4.0 * B * H * hd * S * (S + 1) / 2
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    return dict(max_abs_err=err, tol=TOL_TEXT[dtype_name], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms)


def phase_kernels(torch, ops, ref) -> dict:
    results = {}
    for dtn in ("bfloat16", "float32"):
        r = check_paged(torch, ops, ref, dtn)
        log(f"paged_attention {dtn} B=8 H=16 K=8 hd=128 ps=16 n_pp=34: "
            f"max_err={r['max_abs_err']:.3e} (tol {r['tol']}) "
            f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms=null")
        results[("paged_attention", dtn)] = r
        for S in (512, 300):
            r = check_flash(torch, ops, ref, dtn, S)
            log(f"flash_attention {dtn} B=8 H=16 K=8 S={S} hd=128 causal: "
                f"max_err={r['max_abs_err']:.3e} (tol {r['tol']}) "
                f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
                f"library_ms={r['library_ms']:.5f}")
            results[("flash_attention", dtn, S)] = r
    return results


def phase_serve_full(torch, ops, serve, smi: str) -> dict:
    n_layers = 28
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve("qwen3-0.6b", reduced_cfg=False, n_requests=8, prompt_len=512,
                gen_len=32, max_slots=8, page_size=16,
                cache_dtype="bfloat16", replan="off", device="cuda",
                seed=0, verbose=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    if tuple(toks.shape) != (8, 32):
        raise AssertionError(f"expected (8, 32) tokens, got {tuple(toks.shape)}")
    if not bool(((toks >= 0) & (toks < 151936)).all()):
        raise AssertionError("generated token ids out of the vocabulary")
    pf, ds = out["prefill_calls"], out["decode_steps"]
    if not (counts["flash_attention"] == n_layers * pf
            and counts["paged_attention"] == n_layers * ds
            and counts["flash_attention"] > 0
            and counts["paged_attention"] > 0):
        raise AssertionError(
            f"launch counts {counts} != 28 x (prefill {pf}, decode {ds})")
    log(f"serve qwen3-0.6b full (28L d1024, bf16): {out['requests']} requests "
        f"x 32 tokens; prefill_calls={pf} decode_steps={ds} "
        f"launches={counts}; throughput_tok_s={out['throughput_tok_s']} "
        f"prefill_seconds={out['prefill_seconds']} "
        f"decode_seconds={out['decode_seconds']} "
        f"peak_mem_bytes={peak} on {smi}")
    return counts


def phase_cpu_parity(torch, serve) -> None:
    kw = dict(reduced_cfg=True, n_requests=4, prompt_len=300, gen_len=16,
              max_slots=4, page_size=16, cache_dtype="float32", replan="off",
              seed=3, verbose=False)
    gpu = serve("qwen3-0.6b", device="cuda", **kw)["tokens"]
    cpu = serve("qwen3-0.6b", device="cpu", **kw)["tokens"]
    if not torch.equal(gpu.cpu(), cpu.cpu()):
        raise AssertionError(f"reduced fp32 tokens differ cuda vs cpu:\n"
                             f"{gpu.tolist()}\n{cpu.tolist()}")
    log(f"reduced qwen3 fp32 (4 requests, prompt 300, 16 new): cuda tokens == "
        f"cpu tokens ({cpu.numel()} tokens)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="run the build and kernel checks only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAILED: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref

    # fp32 products in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"gpu: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = build.build_all(ops.KERNELS.values())
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per kernel {secs})")
    for k in ops.KERNELS.values():
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {k.name}: {line.strip()}")

    checks = phase_kernels(torch, ops, ref)
    counts = {name: 0 for name in ops.KERNELS}
    if args.only is None:
        from repro_torch.launch.serve import serve

        counts = phase_serve_full(torch, ops, serve, smi)
        phase_cpu_parity(torch, serve)

    rows = []
    for name in ("paged_attention", "flash_attention"):
        key = (name, "bfloat16") if name == "paged_attention" else (
            name, "bfloat16", 512)
        r = checks[key]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
