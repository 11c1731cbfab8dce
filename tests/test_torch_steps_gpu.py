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
qwen2-moe-a2.7b (``grad_accum`` 2) and llama3-405b (its one KV head split
over "model", the decode cache over the sequence) in fp32, an fp32 cache
(a bf16 one rounds the decode's probabilities, which the card and the
CPU then sum in another order): every loss, trained local block and
logit within 1e-4, the greedy tokens equal.
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
         "llama3-405b": {}}


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
    kw = dict(RUN, arch=arch, sharding=CASES[arch])
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
