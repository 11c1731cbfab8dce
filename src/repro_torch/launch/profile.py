"""Where the serving and training paths' time goes on the GPU
(``torch.profiler``).

    PYTHONPATH=src python -m repro_torch.launch.profile      # full qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --arch seamless-m4t-medium --enc-len 1024         # enc-dec
    PYTHONPATH=src python -m repro_torch.launch.profile --arch pixtral-12b \\
        --stub-len 1024                                   # VLM, one image
    PYTHONPATH=src python -m repro_torch.launch.profile --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.profile --slab  # slab KV
    PYTHONPATH=src python -m repro_torch.launch.profile --train  # one train step

Serving: serves the ``chip_smoke.py`` cell (8 requests × 512-token prompts
× 32 new tokens, bf16, page size 16; an enc-dec arch's requests carry
``enc_len`` frames and a VLM's ``stub_len`` patch embeddings, as
:func:`repro_torch.launch.serve.serve` builds them; ``kv_layout`` paged or
slab) once to warm every
kernel and library handle, then on a fresh session over the same model measures:

* the stacked prefill (one ``admit_many``) under the profiler: wall time,
  device time by kernel group, device busy share;
* decode: the mean step wall time over ``steps`` unprofiled steps, then
  the device time per step by kernel group over ``steps`` profiled ones,
  kernel launches per step, and the idle share = 1 − device / wall.

Device time is the sum of the profiler's CUDA-side events (one stream, so
they do not overlap), grouped into the ported kernels, copies and
the rest, with the largest kernels also listed by name.

Training (``--train``, :func:`profile_train`): full qwen3-0.6b in the
training layout, batch 8 × seq 1024 (``chip_smoke.py`` phase 6's cell),
two warm-up steps, then one profiled step (:func:`profile_train_step`,
which ``chip_smoke.py`` phases 6e and 6f also call on their depth-cut MoE
and hybrid models) whose forward, backward and update are each closed by
a device sync. Its device time is split by the phase a kernel was launched
in and by what launched it (:data:`TRAIN_GROUPS`): the flash kernel in the
forward and in the backward (the remat recompute), the flash backward
kernel with the cotangent's copy, if any (inside the flash autograd
function's backward); the grouped matmul in the forward, in the recompute
and as dx (inside its function's backward), and the rest of that backward
(dw's ``torch.bmm``, the cotangent's mask, w's transposed copy); the scan
in the forward, in the recompute and reversed (inside its function's
backward) with the elementwise rest of that backward; the RG-LRU gate
products (``repro.rglru_gates``: forward and recompute; their backward
counts as matmuls); ``chunked_xent`` (its forward, its backward-time
logits recompute, and the backward nodes of its forward ops, matched by
autograd sequence number), the remaining matmuls (cuBLAS kernels by name),
the optimizer update and the rest.

Prints one line per phase and a JSON line; exits non-zero when the
profiler records no device time.
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
from ..config import get_arch
from .serve import _build_requests, frontend_lens

#: the groups of a train step's device time (see the module doc)
TRAIN_GROUPS = ("flash_forward", "flash_recompute", "flash_backward",
                "gmm_forward", "gmm_recompute", "gmm_dx", "gmm_backward_rest",
                "scan_forward", "scan_recompute", "scan_reverse",
                "scan_backward_rest", "gate_products", "chunked_xent",
                "matmul", "optimizer", "other")
#: substrings of cuBLAS / CUTLASS matmul kernel names on Hopper
MATMUL_KEYS = ("gemm", "nvjet", "xmma", "cutlass")
#: what marks a kernel as launched by the grouped matmul's or the scan's
#: backward: the function's ``record_function`` range, or the autograd
#: node that runs it — a kernel launched through ``ctypes`` is filed under
#: the node's op, outside the range
BACKWARD_NODES = {"repro.flash_backward": "_FlashAttentionBackward",
                  "repro.gmm_backward": "_GroupedMatmulBackward",
                  "repro.scan_backward": "_RGLRUScanBackward"}

# substrings of the kernels' names: paged_decode_split_kernel;
# flash_fwd_kernel (fp32) and flash_fwd_wgmma_kernel (bf16); the flash
# backward's flash_bwd_dot_kernel, flash_bwd_{dkv,dq}_f32_kernel and
# flash_bwd_{dkv,dq}_wgmma_kernel;
# gmm_bf16_kernel, gmm_wgmma_kernel, gmm_skinny_kernel and gmm_f32_kernel
GROUPS = (("paged_attention", "paged_decode_split"),
          ("flash_attention", "flash_fwd_"),
          ("flash_attention_bwd", "flash_bwd_"),
          ("grouped_matmul", "gmm_"),
          ("rglru_scan", "rglru_scan_kernel"),
          ("copy", "emcpy"))
TOP = 6


def device_times(prof) -> Tuple[Dict[str, float], Dict[str, float], int]:
    """Device µs by kernel group, the ``TOP`` kernels by name (µs), and the
    number of device events of a profiler run.  A ``record_function``
    range also shows on the device timeline, spanning the kernels it
    launched: only the kernels (and copies) are counted."""
    by_group: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    count = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.time_range.elapsed_us()
        group = next((g for g, key in GROUPS if key in e.name), "other")
        by_group[group] = by_group.get(group, 0.0) + us
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us
        count += 1
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP])
    return by_group, top, count


def profile_serve(arch: str = "qwen3-0.6b", *, reduced_cfg: bool = False,
                  n_requests: int = 8, prompt_len: int = 512,
                  gen_len: int = 32, seed: int = 0, warm_steps: int = 3,
                  steps: int = 12, enc_len: int = 0,
                  stub_len: int = 0, kv_layout: str = "paged") -> dict:
    if 1 + warm_steps + 2 * steps > gen_len:
        raise ValueError("gen_len too short for the warm + measured steps")
    enc, stub = frontend_lens(get_arch(arch), prompt_len, enc_len, stub_len)
    cfg = ServingConfig(arch=arch, reduced_cfg=reduced_cfg, seed=seed,
                        device="cuda", max_slots=n_requests,
                        cache_len=prompt_len + stub + gen_len, enc_len=enc,
                        kv_layout=kv_layout)
    warm = ServingSession(cfg)
    reqs = _build_requests(warm.model.cfg, n_requests=n_requests,
                           prompt_len=prompt_len, gen_len=gen_len, seed=seed,
                           arrival_every=0.0, enc_len=enc, stub_len=stub)
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


def _ancestors(evt):
    """The event and its enclosing host events, innermost first."""
    out = []
    while evt is not None:
        out.append(evt)
        evt = evt.cpu_parent
    return out


def train_breakdown(events, phases: Dict[str, Tuple[float, float]]
                    ) -> Dict[str, float]:
    """Device µs of a profiled train step by :data:`TRAIN_GROUPS`.
    ``events`` is the profiler's event list; ``phases`` maps "forward",
    "backward" and "update" to the host-time range (µs) each ran in —
    a kernel's phase is that of the host op that launched it, and its
    marks the host op's ancestors' names (with :data:`BACKWARD_NODES`)."""
    def phase_of(evt):
        t = evt.time_range.start
        return next((name for name, (lo, hi) in phases.items()
                     if lo <= t <= hi), None)

    # the forward ops of chunked_xent, by autograd sequence number: their
    # backward nodes carry the same number
    xent_seq = {e.sequence_nr for e in events
                if e.sequence_nr >= 0 and phase_of(e) == "forward"
                and any(a.name == "repro.chunked_xent"
                        for a in _ancestors(e))}
    out = {g: 0.0 for g in TRAIN_GROUPS}
    for e in events:
        if not e.kernels:
            continue
        phase = phase_of(e)
        anc = _ancestors(e)
        names = {a.name for a in anc}
        marks = names | {m for m, node in BACKWARD_NODES.items()
                         if any(node in n for n in names)}
        in_xent = "repro.chunked_xent" in names or any(
            a.name.startswith("autograd::engine::evaluate_function")
            and a.sequence_nr in xent_seq for a in anc)
        again = "recompute" if phase == "backward" else "forward"
        for k in e.kernels:
            if phase == "update":
                group = "optimizer"
            elif "flash_fwd" in k.name:
                group = f"flash_{again}"
            elif "repro.flash_backward" in marks:
                group = "flash_backward"
            elif "repro.gmm_backward" in marks:
                group = "gmm_dx" if "gmm_" in k.name else "gmm_backward_rest"
            elif "gmm_" in k.name:
                group = f"gmm_{again}"
            elif "repro.scan_backward" in marks:
                group = ("scan_reverse" if "rglru_scan" in k.name
                         else "scan_backward_rest")
            elif "rglru_scan" in k.name:
                group = f"scan_{again}"
            elif "repro.rglru_gates" in marks:
                group = "gate_products"
            elif in_xent:
                group = "chunked_xent"
            elif any(key in k.name.lower() for key in MATMUL_KEYS):
                group = "matmul"
            else:
                group = "other"
            out[group] += k.duration
    return out


def profile_train_step(model, optimizer, params, state, batch) -> dict:
    """One profiled train step (loss, gradients, AdamW update) of a model
    in the training layout on the GPU, each phase closed by a device sync:
    wall and device time, device time by :data:`TRAIN_GROUPS`, the top
    kernels and the kernels' launches in the step.  The caller warms the
    model up first."""
    from ..kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("repro.train.forward"):
            loss, _ = model.loss(batch)
            torch.cuda.synchronize()
        with torch.profiler.record_function("repro.train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
        with torch.profiler.record_function("repro.train.update"):
            optimizer.update(dict(zip(params, grads)), state, params)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    events = prof.events()
    # the host-side ranges (each also shows on the device timeline)
    phases = {name: (e.time_range.start, e.time_range.end) for e in events
              for name in ("forward", "backward", "update")
              if e.name == f"repro.train.{name}"
              and e.device_type == torch.autograd.DeviceType.CPU}
    groups = train_breakdown(events, phases)
    by_group, top, n_events = device_times(prof)
    device_s = sum(by_group.values()) / 1e6
    return {
        "device": torch.cuda.get_device_name(0),
        "loss": float(loss.detach()),
        "step_wall_s": wall,
        "step_device_s": device_s,
        "step_device_us_by_group": groups,
        "step_device_us_attributed": sum(groups.values()),
        "step_top_kernels_us": top,
        "step_device_events": n_events,
        "step_idle_share": 1.0 - device_s / wall,
        "launches": launches,
        "flash_launches": launches["flash_attention"],
    }


def profile_train(arch: str = "qwen3-0.6b", *, batch: int = 8,
                  seq: int = 1024, seed: int = 0, warm_steps: int = 2) -> dict:
    """One profiled train step of the full ``arch`` on the GPU, after
    ``warm_steps`` steps (see the module doc)."""
    from ..config import default_sharding, get_arch
    from ..data import DataConfig, SyntheticLM
    from ..models import build_model
    from ..optim import AdamW
    from .train import make_train_state, train_step

    dev = torch.device("cuda")
    cfg = get_arch(arch)
    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device="cuda", train=True)
    optimizer = AdamW(lr=3e-4)
    params, state = make_train_state(model, optimizer, seed)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    for step in range(warm_steps):
        b = {k: v.to(dev) for k, v in data.batch(step).items()}
        state, _ = train_step(model, optimizer, params, state, b)
    b = {k: v.to(dev) for k, v in data.batch(warm_steps).items()}
    out = profile_train_step(model, optimizer, params, state, b)
    return {"arch": arch, "batch": batch, "seq": seq, **out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of serving")
    ap.add_argument("--enc-len", type=int, default=0,
                    help="enc-dec archs: frames per request")
    ap.add_argument("--stub-len", type=int, default=0,
                    help="VLM archs: patch embeddings per request")
    ap.add_argument("--slab", action="store_true",
                    help="per-slot KV slabs instead of the page pool")
    args = ap.parse_args()
    if args.train:
        out = profile_train(args.arch, seed=args.seed)
        if out["step_device_s"] <= 0:
            print("[profile] FAILED: the profiler recorded no device time",
                  file=sys.stderr)
            return 1
        print(f"[profile] {out['device']}: train step "
              f"{out['step_wall_s']:.6f} s wall, {out['step_device_s']:.6f} "
              f"s device (idle {out['step_idle_share']:.3f}); by group (us) "
              f"{out['step_device_us_by_group']}")
        print(json.dumps(out))
        return 0
    out = profile_serve(args.arch, reduced_cfg=args.reduced, seed=args.seed,
                        enc_len=args.enc_len, stub_len=args.stub_len,
                        kv_layout="slab" if args.slab else "paged")
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
