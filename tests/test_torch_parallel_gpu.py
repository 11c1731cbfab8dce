"""Multi-rank training on the card against one process, at reduced size.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_parallel_gpu.py

* a world of one process on the NCCL backend, a (1, 1) mesh: three steps
  of reduced qwen2-moe in fp32 equal ``train(mesh=None)`` bit for bit;
* two ranks sharing the card through gloo, a (data 1, model 2) mesh
  (expert parallelism, the grouped-matmul kernel on each rank's 4 local
  experts): the same three steps equal the one-process run within 1e-5,
  and every replicated parameter is bit-identical on both ranks.
"""

import pytest
import torch

from repro_torch.config import get_arch, reduced
from repro_torch.launch.train import train
from repro_torch.parallel import make_mesh
from repro_torch.parallel.mesh import run_ranks

RUN = dict(reduced_cfg=False, steps=3, batch=4, seq=64, lr=1e-3, seed=0)
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    return reduced(get_arch("qwen2-moe-a2.7b"))


def _rank(rank, shape):
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    out = train(_cfg(), device="cuda", verbose=False, mesh=mesh, **RUN)
    return {"backend": dist.get_backend(), "history": out["history"],
            "params": {k: v.detach().cpu() for k, v in out["params"].items()}}


@pytest.mark.cuda
def test_one_rank_nccl_mesh_equals_one_process(cuda_device):
    one = train(_cfg(), device="cuda", verbose=False, **RUN)["history"]
    (r,) = run_ranks(_rank, 1, "cuda", args=((1, 1),))
    assert r["backend"] == "nccl"
    assert r["history"] == one


@pytest.mark.cuda
def test_ep_on_two_ranks_sharing_the_card(cuda_device):
    one = train(_cfg(), device="cuda", verbose=False, **RUN)["history"]
    ranks = run_ranks(_rank, 2, "cuda", args=((1, 2),))
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert ranks[0]["history"] == ranks[1]["history"]
    assert max(abs(a - b) for a, b in zip(ranks[0]["history"], one)) <= TOL
    p0, p1 = ranks[0]["params"], ranks[1]["params"]
    for k in p0:
        if k.rsplit(".", 1)[-1].startswith("we_"):
            assert p0[k].shape[0] == p1[k].shape[0] == 4
        else:
            assert torch.equal(p0[k], p1[k]), k
