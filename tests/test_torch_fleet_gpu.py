"""The port's fleet on the card against the CPU's plain path.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_fleet_gpu.py

The fleet's clock is the planner's, so its ``metrics()`` cannot depend on
the device; its serve jobs' tokens come from the paged-decode kernel on
the card and from its plain version on the CPU, in fp32 compute (TF32
off), and must be equal.
"""

import pytest
import torch

from repro_torch.config import default_sharding, get_arch, reduced
from repro_torch.core.placement import ClusterSpec
from repro_torch.fleet import FleetConfig, FleetScheduler, JobSpec
from repro_torch.launch.faults import FaultInjector, FaultScript
from repro_torch.models import build_model

#: tests/test_faults.py:355's cluster
CLUSTER = ClusterSpec(n_devices=32, island_size=4, devices_per_host=4,
                      mem_bytes=96e9)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def host_failure_fleet(device: str):
    """tests/test_faults.py:440: a train job and a reduced qwen3 serve job;
    hosts 4 and 5 die at step 6.  Returns (metrics, tokens per rid)."""
    jobs = [
        JobSpec(name="t0", kind="train", workload="multitask_clip", steps=12),
        JobSpec(name="s0", kind="serve", arch="qwen3-0.6b", requests=6,
                prompt_len=8, gen_len=4, slots=2, cache_len=32),
    ]
    inj = FaultInjector(CLUSTER.n_hosts,
                        schedule=[FaultScript(step=6, hosts=(4, 5))])
    fleet = FleetScheduler(FleetConfig(cluster=CLUSTER, device=device), jobs,
                           event_sources=[inj])
    m = fleet.run()
    fleet.arbiter.check()
    results = fleet.jobs["s0"].session.results
    return m, {rid: list(r.tokens) for rid, r in results.items()}


@pytest.mark.cuda
def test_host_failure_fleet_cuda_equals_cpu(cuda_device):
    gpu, gpu_tokens = host_failure_fleet("cuda")
    cpu, cpu_tokens = host_failure_fleet("cpu")
    assert gpu["host_failures"] == 1 and gpu["requeued_requests"] >= 1
    assert gpu == cpu
    assert gpu_tokens == cpu_tokens


@pytest.mark.cuda
@pytest.mark.parametrize("fleet_device, model_device",
                         [("cuda", "cpu"), ("cpu", "cuda")])
def test_cached_model_on_another_device_raises(cuda_device, fleet_device,
                                               model_device):
    cfg = reduced(get_arch("qwen3-0.6b"))
    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device=model_device).init(0)
    fleet = FleetScheduler(
        FleetConfig(device=fleet_device),
        [JobSpec(name="s0", kind="serve", requests=1, prompt_len=8,
                 gen_len=2, slots=1, cache_len=16)],
        model_cache={"qwen3-0.6b": model})
    with pytest.raises(ValueError, match="lives on"):
        fleet.run()
