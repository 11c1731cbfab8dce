"""Checkpoints and crash recovery with CUDA tensors, against the CPU.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_ckpt_gpu.py

* an async snapshot of CUDA params and moments, followed at once by an
  in-place AdamW step, holds the pre-step values bit for bit;
* a bf16 CUDA tree round-trips bit for bit and comes back on the CPU;
* ``restore_to_mesh`` places a restored tree on the card (one device or
  a device per leaf);
* the crash smoke (kill, rollback, replay) on ``cuda`` gives the CPU's
  loss history within 1e-5 (fp32, TF32 off).
"""

import numpy as np
import pytest
import torch

from repro_torch.ckpt import (AsyncCheckpointManager, restore_checkpoint,
                              restore_to_mesh, save_checkpoint)
from repro_torch.optim import AdamW


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 32, generator=g).to(dev),
            "b": torch.randn(32, generator=g).to(dev)}


@pytest.mark.cuda
def test_async_snapshot_of_cuda_state_survives_in_place_step(cuda_device,
                                                             tmp_path):
    params = _params(cuda_device)
    opt = AdamW(lr=1e-1)
    state = opt.update({k: torch.ones_like(v) for k, v in params.items()},
                       opt.init(params), params)
    want = {k: v.cpu().clone() for k, v in params.items()}
    want_nu = {k: v.cpu().clone() for k, v in state.nu.items()}
    mgr = AsyncCheckpointManager(str(tmp_path), every=1)
    with mgr._cv:  # the writer cannot take the snapshot before the step
        mgr.save(1, {"params": params, "opt": state})
        state = opt.update({k: torch.full_like(v, 3.0)
                            for k, v in params.items()}, state, params)
        torch.cuda.synchronize()
    restored, manifest = mgr.restore_latest({"params": params, "opt": state})
    mgr.close()
    assert manifest["step"] == 1 and restored["opt"].count == 1
    for k in params:
        assert not torch.equal(params[k].cpu(), want[k])
        assert torch.equal(restored["params"][k], want[k])
        assert torch.equal(restored["opt"].nu[k], want_nu[k])


@pytest.mark.cuda
def test_bf16_cuda_roundtrip(cuda_device, tmp_path):
    tree = {k: v.to(torch.bfloat16) for k, v in _params(cuda_device).items()}
    save_checkpoint(str(tmp_path), 0, tree)
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert {l["dtype"] for l in manifest["leaves"]} == {"bfloat16"}
    for k, v in tree.items():
        assert restored[k].device.type == "cpu"
        assert restored[k].dtype == torch.bfloat16
        assert torch.equal(restored[k], v.cpu())


@pytest.mark.cuda
def test_restore_to_mesh_onto_cuda(cuda_device, tmp_path):
    tree = _params("cpu", 1)
    save_checkpoint(str(tmp_path), 0, tree)
    restored, _ = restore_checkpoint(str(tmp_path), tree)
    placed = restore_to_mesh(restored, cuda_device)
    per_leaf = restore_to_mesh(restored, {"w": cuda_device, "b": "cpu"})
    for k, v in tree.items():
        assert placed[k].device.type == "cuda"
        assert torch.equal(placed[k].cpu(), v)
    assert per_leaf["w"].is_cuda and per_leaf["b"].device.type == "cpu"


@pytest.mark.cuda
def test_crash_smoke_on_cuda_matches_cpu(cuda_device, capsys):
    from repro_torch.launch.train import crash_smoke

    kw = dict(steps=8, kill_at=3, kill_hosts=(1,), ckpt_every=2,
              verbose=False)
    gpu = crash_smoke(device="cuda", **kw)
    cpu = crash_smoke(device="cpu", **kw)
    assert capsys.readouterr().out.count("[crash] OK") == 2
    assert [r.mode for r in gpu["replans"]] == ["restore"]
    np.testing.assert_allclose(gpu["history"], cpu["history"], atol=1e-5)
