"""Analytic NVIDIA H100 cost model — the profiling source for the estimator.

The paper profiles ``T_m(n)`` on the physical cluster.  The port plans for
H100 SXM5 cards and models them with a roofline in two parts:

  * from NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16 per card,
    3.35 TB/s HBM3 bandwidth, and NVLink 4 at 900 GB/s per card, 450 GB/s
    each way (the ``ici_bw`` field keeps its name and means NVLink here);
  * fitted on the card: ``mxu_max_eff``, ``mxu_knee_flops`` and
    ``token_knee`` to bf16 ``torch.matmul`` device times over a sweep of
    (M, K, N) from light to heavy products, and ``t_launch`` to the host
    time of launching one small op.  The sweep and the fit are
    phase 3b of ``python3 chip_smoke.py``, which prints each shape's
    measured time beside :func:`op_time` under :data:`H100` and refits
    the four constants.

Per-operator time under ``ParallelConfig(dp, tp)`` with ``n = dp·tp`` cards:

  t_compute = flops / (n · PEAK · eff)      eff = tensor-core utilization,
                                            saturating both in per-card
                                            FLOPs and in per-DP-shard tokens
                                            (the matmul M-dimension): light
                                            ops and high DP degrees cannot
                                            fill the tensor cores — this is
                                            what makes light MetaOps scale
                                            poorly (Fig. 4) and what the
                                            paper's "lightweight audio
                                            operator on 16 GPUs is
                                            underutilized or idle" describes.
  t_memory  = bytes_hbm / (n · HBM_BW)
  t_tp_comm = tp-collective payload / NVLink   (0 when tp == 1)
  T = max(t_compute, t_memory) + t_tp_comm + T_LAUNCH

The max() models compute/memory overlap inside a fused op; TP collectives
are exposed (they sit on the critical path between layer halves).
"""

from __future__ import annotations

from dataclasses import dataclass

from .contraction import MetaOp
from .estimator import ParallelConfig

# H100 SXM5 data sheet (dense, no sparsity), per card.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12  # bytes/s
ICI_BW = 450e9  # bytes/s: NVLink 4, one direction
# The four fitted constants below come from one run of chip_smoke.py's spec
# phase on an "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name and
# power.limit), with torch 2.11.0+cu128.  A later run of the whole script
# with them committed, on the same card model and limit, measured op_time
# within 0.663-1.062x of each swept shape's time.
T_LAUNCH = 7.6e-6  # host time to launch one small op, seconds


@dataclass(frozen=True)
class HardwareSpec:
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    t_launch: float = T_LAUNCH
    # per-card FLOPs at which the tensor cores reach ~50% of their
    # asymptotic efficiency: how quickly light ops fall off the roofline
    # (fitted, see the module docstring).
    mxu_knee_flops: float = 4.0e9
    mxu_max_eff: float = 0.78  # large bf16 torch.matmul over the peak (fitted)
    # per-DP-shard tokens (the matmul M-dimension) at which a product
    # reaches ~50% utilization (fitted: the card's products lose little to
    # few rows once the FLOP knee is counted).
    token_knee: float = 3.2


H100 = HardwareSpec()


def op_time(m: MetaOp, cfg: ParallelConfig, hw: HardwareSpec = H100) -> float:
    """Per-operator execution time (seconds) under ``cfg``. See module doc."""
    n = cfg.n
    w = m.workload
    flops_per_chip = w.flops / n
    tokens_per_shard = max(m.batch_size * max(m.seq_len, 1) / cfg.dp, 1.0)
    eff = (
        hw.mxu_max_eff
        * (flops_per_chip / (flops_per_chip + hw.mxu_knee_flops))
        * (tokens_per_shard / (tokens_per_shard + hw.token_knee))
    )
    eff = max(eff, 1e-3)
    t_compute = flops_per_chip / (hw.peak_flops * eff)
    t_memory = w.bytes_hbm / (n * hw.hbm_bw)
    t_tp = 0.0
    if cfg.tp > 1 and w.tp_comm_bytes > 0:
        # ring all-reduce of the per-dp-shard payload over tp cards:
        # 2·(tp-1)/tp of the payload crosses each link.
        payload = w.tp_comm_bytes / cfg.dp
        t_tp = 2.0 * (cfg.tp - 1) / cfg.tp * payload / hw.ici_bw
    return max(t_compute, t_memory) + t_tp + hw.t_launch


def h100_time_fn(m: MetaOp, cfg: ParallelConfig) -> float:
    return op_time(m, cfg, H100)


def make_time_fn(hw: HardwareSpec):
    def fn(m: MetaOp, cfg: ParallelConfig) -> float:
        return op_time(m, cfg, hw)

    return fn
