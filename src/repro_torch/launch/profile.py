"""Where the serving path's time goes on the GPU (``torch.profiler``).

    PYTHONPATH=src python -m repro_torch.launch.profile      # full qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch recurrentgemma-9b

Serves the ``chip_smoke.py`` cell (8 requests × 512-token prompts × 32
new tokens, bf16, page size 16) once to warm every kernel and library
handle, then on a fresh session over the same model measures:

* the stacked prefill (one ``admit_many``) under the profiler: wall time,
  device time by kernel group, device busy share;
* decode: the mean step wall time over ``steps`` unprofiled steps, then
  the device time per step by kernel group over ``steps`` profiled ones,
  kernel launches per step, and the idle share = 1 − device / wall.

Device time is the sum of the profiler's CUDA-side events (one stream, so
they do not overlap), grouped into the four ported kernels, copies and
the rest, with the largest kernels also listed by name.  Prints one line per
phase and a JSON line; exits non-zero when the profiler records no device
time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from ..serving import ServingConfig, ServingSession
from .serve import _build_requests

# substrings of the kernels' names: paged_decode_split_kernel;
# flash_fwd_kernel (fp32) and flash_fwd_wgmma_kernel (bf16);
# gmm_bf16_kernel, gmm_wgmma_kernel, gmm_skinny_kernel and gmm_f32_kernel
GROUPS = (("paged_attention", "paged_decode_split"),
          ("flash_attention", "flash_fwd_"),
          ("grouped_matmul", "gmm_"),
          ("rglru_scan", "rglru_scan_kernel"),
          ("copy", "emcpy"))
TOP = 6


def device_times(prof) -> Tuple[Dict[str, float], Dict[str, float], int]:
    """Device µs by kernel group, the ``TOP`` kernels by name (µs), and the
    number of device events of a profiler run."""
    by_group: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    count = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        group = next((g for g, key in GROUPS if key in e.key), "other")
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + us
        count += e.count
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP])
    return by_group, top, count


def profile_serve(arch: str = "qwen3-0.6b", *, reduced_cfg: bool = False,
                  n_requests: int = 8, prompt_len: int = 512,
                  gen_len: int = 32, seed: int = 0, warm_steps: int = 3,
                  steps: int = 12) -> dict:
    if 1 + warm_steps + 2 * steps > gen_len:
        raise ValueError("gen_len too short for the warm + measured steps")
    cfg = ServingConfig(arch=arch, reduced_cfg=reduced_cfg, seed=seed,
                        device="cuda", max_slots=n_requests,
                        cache_len=prompt_len + gen_len)
    warm = ServingSession(cfg)
    vocab = warm.model.cfg.vocab
    reqs = _build_requests(vocab, n_requests=n_requests,
                           prompt_len=prompt_len, gen_len=gen_len, seed=seed,
                           arrival_every=0.0)
    warm.run(reqs)
    b = ServingSession(cfg, model=warm.model).batcher
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()

    with profile(activities=acts) as p_pre:
        t0 = time.perf_counter()
        b.admit_many(reqs)
        prefill_wall = time.perf_counter() - t0
    pre_dev, pre_top, pre_n = device_times(p_pre)

    for _ in range(warm_steps):
        b.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        b.step()
    step_wall = (time.perf_counter() - t0) / steps
    with profile(activities=acts) as p_dec:
        for _ in range(steps):
            b.step()
        torch.cuda.synchronize()
    dec_dev, dec_top, dec_n = device_times(p_dec)
    dec_step = {k: v / steps for k, v in dec_dev.items()}
    dec_top = {k: v / steps for k, v in dec_top.items()}

    pre_total = sum(pre_dev.values()) / 1e6
    dec_total = sum(dec_step.values()) / 1e6
    return {
        "device": torch.cuda.get_device_name(0),
        "prefill_wall_s": prefill_wall,
        "prefill_device_s": pre_total,
        "prefill_device_us_by_group": pre_dev,
        "prefill_top_kernels_us": pre_top,
        "prefill_device_events": pre_n,
        "prefill_busy_share": pre_total / prefill_wall,
        "decode_step_wall_s": step_wall,
        "decode_step_device_s": dec_total,
        "decode_step_device_us_by_group": dec_step,
        "decode_step_top_kernels_us": dec_top,
        "decode_launches_per_step": dec_n / steps,
        "decode_idle_share": 1.0 - dec_total / step_wall,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    out = profile_serve(args.arch, reduced_cfg=args.reduced, seed=args.seed)
    if out["prefill_device_s"] <= 0 or out["decode_step_device_s"] <= 0:
        print("[profile] FAILED: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(f"[profile] {out['device']}: prefill {out['prefill_wall_s']:.6f} s "
          f"wall, {out['prefill_device_s']:.6f} s device "
          f"(busy {out['prefill_busy_share']:.3f}); by group (us) "
          f"{out['prefill_device_us_by_group']}")
    print(f"[profile] decode step {out['decode_step_wall_s']:.6f} s wall, "
          f"{out['decode_step_device_s']:.6f} s device (idle "
          f"{out['decode_idle_share']:.3f}); "
          f"{out['decode_launches_per_step']:.0f} device events/step; by "
          f"group (us/step) {out['decode_step_device_us_by_group']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
