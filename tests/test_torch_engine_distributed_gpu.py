"""The distributed WaveEngine on the card: four ranks sharing it.

Marked ``cuda`` and skipped without a GPU.  This file imports no JAX, so
it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_engine_distributed_gpu.py

* four ranks sharing the card through gloo (the moves staged through host
  memory): every rank's loss and gradients on clip and ofasys planned for
  4 devices equal autograd of ``reference_loss`` on the card within 1e-5
  / 1e-4, fp32;
* the straggler session of ``tests/test_torch_engine_distributed.py`` on
  the card: the restore of step 2, live mesh ``[0, 1]``, histories equal to
  a one-process session on the card driven by the same events within
  1e-4, bit-identical live replicas.
"""

import hashlib

import pytest
import torch

from repro_torch.core import ClusterSpec, plan
from repro_torch.parallel.mesh import run_ranks
from repro_torch.runtime import WaveEngine, tiny_multitask_clip, tiny_ofasys

LOSS_TOL, GRAD_TOL, HIST_TOL = 1e-5, 1e-4, 1e-4
CLUSTER = dict(n_devices=4, island_size=4, devices_per_host=2,
               mem_bytes=80e9)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine_rank(rank):
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, maker in (("clip", tiny_multitask_clip), ("ofasys", tiny_ofasys)):
        model, batches = maker(n_tasks=3)
        params = model.init(0, device="cuda")
        batches = {t: {k: v.cuda() for k, v in b.items()}
                   for t, b in batches.items()}
        eng = WaveEngine(model, plan(model.graph, ClusterSpec(**CLUSTER)),
                         distributed=True)
        loss, grads = eng.loss_and_grads(params, batches)
        ref_l, ref_g = model.reference_loss_and_grads(params, batches)
        out[name] = (abs(float(loss) - float(ref_l)),
                     max(float((grads[n] - g).abs().max())
                         for n, g in ref_g.items()))
    return out


def _session(mesh, ckpt_dir):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.events import (ScriptedEventSource,
                                           StragglerDetected)
    from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                     SpindleSession)

    return SpindleSession(
        SessionConfig(cluster=ClusterSpec(**CLUSTER), straggler_shrink=True,
                      mesh=mesh, device="cuda"),
        model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts)),
        tasks=("img_text", "audio_text"),
        callbacks=[CheckpointCallbacks(CheckpointManager(ckpt_dir, every=0))],
        event_sources=[ScriptedEventSource([StragglerDetected((1,))],
                                           fire_at=[2])]).bind()


def _session_rank(rank, ckpt_dir):
    from repro_torch.parallel import mesh_over_devices

    torch.backends.cuda.matmul.allow_tf32 = False
    s = _session(mesh_over_devices(range(4), device="cuda"), ckpt_dir)
    s.run(5)
    rec = next(r for r in s.replans if r.mode == "restore")
    sha = hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes() for p in s.params.parameters())
    ).hexdigest()
    return dict(history=list(s.history), restored_step=rec.restored_step,
                live=list(s.engine.live), sha=sha)


@pytest.mark.cuda
def test_engine_on_four_ranks_sharing_the_card(cuda_device):
    for r in run_ranks(_engine_rank, 4, "cuda"):
        for name, (dl, dg) in r.items():
            assert dl < LOSS_TOL and dg < GRAD_TOL, (name, dl, dg)


@pytest.mark.cuda
def test_straggler_session_on_the_card(cuda_device, tmp_path):
    one = _session(None, str(tmp_path / "one")).run(5)["history"]
    ranks = run_ranks(_session_rank, 4, "cuda",
                      args=(str(tmp_path / "ranks"),))
    for r in ranks:
        assert r["restored_step"] == 2 and r["live"] == [0, 1]
        assert r["history"] == ranks[0]["history"]
        assert max(abs(a - b) for a, b in zip(r["history"], one)) <= HIST_TOL
    assert ranks[0]["sha"] == ranks[1]["sha"]
