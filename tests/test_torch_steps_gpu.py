"""The placed steps (``repro_torch.launch.steps``) on the card against the
CPU, at reduced size.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_steps_gpu.py

Four ranks share the card through gloo on a (data 2, model 2) mesh and
run ``placed_run`` (three train steps, a prefill and two greedy serve
steps, the kernels on: the grouped matmul on each rank's local experts);
four CPU ranks run the same with the plain versions.  Reduced qwen3-0.6b,
qwen2-moe-a2.7b (``grad_accum`` 2), llama3-405b (its one KV head split
over "model", the decode cache over the sequence), recurrentgemma-9b (the
scan on each rank's features; a 100-token prompt, so the decode writes
wrap around its circular window of 64, split over "model" by positions),
xlstm-125m and seamless-m4t-medium in fp32, an fp32 cache
(a bf16 one rounds the decode's probabilities, which the card and the
CPU then sum in another order): every loss, trained local block and
logit within 1e-4, the greedy tokens equal.  And the Megatron-SP train
steps of reduced qwen3, qwen2-moe and recurrentgemma at S 320 (flash on
each rank's heads over the gathered sequence), losses and trained blocks
within 1e-4.
"""

import pytest
import torch

from repro_torch.launch.steps import _placed_rank
from repro_torch.parallel.mesh import run_ranks

TOL = 1e-4
RUN = dict(reduced_cfg=True, mesh_shape=(2, 2), batch=8, seq=32, steps=3,
           prompt_len=64, gen=2, seed=0, keep_params=True,
           cache_dtype="float32")
CASES = {"qwen3-0.6b": {}, "qwen2-moe-a2.7b": {"grad_accum": 2},
         "llama3-405b": {}, "recurrentgemma-9b": {}, "xlstm-125m": {},
         "seamless-m4t-medium": {}}
#: runs that take another prompt length
PROMPT = {"recurrentgemma-9b": 100}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(CASES))
def test_placed_steps_on_the_card_equal_the_cpu(cuda_device, arch):
    kw = dict(RUN, arch=arch, sharding=CASES[arch],
              prompt_len=PROMPT.get(arch, RUN["prompt_len"]))
    gpu = run_ranks(_placed_rank, 4, "cuda", args=(dict(kw, device="cuda"),))
    cpu = run_ranks(_placed_rank, 4, "cpu", args=(dict(kw, device="cpu"),))
    for g, c in zip(gpu, cpu):
        assert g["backend"] == "gloo" and g["coord"] == c["coord"]
        assert max(abs(x - y) for x, y in zip(g["train"]["losses"],
                                               c["train"]["losses"])) <= TOL
        for n, t in c["train"]["params"].items():
            assert _diff(g["train"]["params"][n], t) <= TOL, n
        assert _diff(g["prefill"]["logits"], c["prefill"]["logits"]) <= TOL
        for a, b in zip(g["serve"]["logits"], c["serve"]["logits"]):
            assert _diff(a, b) <= TOL
        assert torch.equal(g["serve"]["tokens"], c["serve"]["tokens"])
        gmm = g["train"]["counts"]["grouped_matmul"]
        assert (gmm > 0) == ("moe" in arch), gmm
        scans = g["train"]["counts"]["rglru_scan"]
        assert (scans > 0) == (arch == "recurrentgemma-9b"), scans


#: Megatron-SP train steps (``serve=False``: SP never runs with a cache):
#: arch: (sharding, config overrides, the kernels its step launches)
SP_CASES = {"qwen3-0.6b": ({"seq_parallel": True}, None,
                           ("flash_attention",)),
            "qwen2-moe-a2.7b": ({"seq_parallel": True, "grad_accum": 2},
                                None, ("flash_attention", "grouped_matmul")),
            "recurrentgemma-9b": ({"seq_parallel": True}, {"n_layers": 4},
                                  ("rglru_scan",))}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(SP_CASES))
def test_sp_train_steps_on_the_card_equal_the_cpu(cuda_device, arch):
    """Megatron-SP's train steps (the residual stream split along the
    sequence over "model"; recurrentgemma at 4 layers runs a remainder
    layer outside SP): every loss and trained local block within 1e-4 of
    the CPU ranks', flash on each rank's heads over the gathered sequence
    at S 320 (> 256: the kernel; recurrentgemma's attention is windowed:
    its scan on each rank's features instead)."""
    sharding, over, kernels = SP_CASES[arch]
    kw = dict(RUN, arch=arch, sharding=sharding, cfg_overrides=over,
              seq=320, serve=False)
    gpu = run_ranks(_placed_rank, 4, "cuda", args=(dict(kw, device="cuda"),))
    cpu = run_ranks(_placed_rank, 4, "cpu", args=(dict(kw, device="cpu"),))
    for g, c in zip(gpu, cpu):
        assert g["coord"] == c["coord"] and "prefill" not in g
        assert max(abs(x - y) for x, y in zip(g["train"]["losses"],
                                               c["train"]["losses"])) <= TOL
        for n, t in c["train"]["params"].items():
            assert _diff(g["train"]["params"][n], t) <= TOL, n
        assert all(g["train"]["counts"][k] > 0 for k in kernels)
