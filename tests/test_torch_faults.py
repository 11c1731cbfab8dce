"""The port's fault injection and crash recovery against the JAX package's,
on the CPU.

* ``FaultInjector`` gives the same event trace and counters as JAX's on
  the five schedules of ``tests/test_faults.py::TestFaultInjector``
  (scripted kills, a debounced and a reported flap, the seeded
  probabilistic one, the out-of-range refusal);
* the port's ``TestSessionHardFailure``: a hard kill at steps 1, 3 and 5
  recovers to the loss history of an uninterrupted run on the survivors
  (1e-6, the reference's bound), a short flap is debounced, a long one
  is evicted and restored, a plan-only session warns, and a ``batch_fn``
  data cursor is replayed; a kill with no durable snapshot degrades to a
  plain shrink with a warning, and a failed restore leaves the live
  session untouched;
* the cooperative straggler restore of ``tests/test_session.py:234-283``;
* one parity case against the JAX session: a kill at step 3 on params
  bridged through ``bridge.load_mt_params`` gives the same replan modes,
  restored step, rollback steps and final plan devices, and the same loss
  history within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.launch.faults as jax_faults
from repro_torch.ckpt import (AsyncCheckpointManager, CheckpointManager,
                              restore_checkpoint)
from repro_torch.ckpt.remesh import fresh_module
from repro_torch.core import ClusterSpec
from repro_torch.launch import faults
from repro_torch.launch.events import HostFailed, StragglerDetected
from repro_torch.runtime import tiny_multitask_clip
from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                 SpindleSession)

from port_testing import one_torch_thread, unoptimized_jax  # noqa: F401

TASKS = ("img_text", "audio_text", "audio_vision")
#: two devices per host so killing host 1 removes a re-plannable block
CLUSTER_KW = dict(n_devices=8, island_size=4, devices_per_host=2,
                  mem_bytes=96e9)
CLUSTER = ClusterSpec(**CLUSTER_KW)


def make_session(cluster=CLUSTER, **kw):
    config = {"cluster": cluster, "device": "cpu", **kw.pop("config", {})}
    return SpindleSession(
        SessionConfig(**config),
        model_factory=lambda tasks: tiny_multitask_clip(n_tasks=len(tasks)),
        tasks=TASKS,
        **kw,
    )


def _plan_devices(sess):
    return {d for s in sess.current_plan.steps for d in s.devices}


# ----------------------------------------------------------- fault injector

#: tests/test_faults.py::TestFaultInjector: (hosts, injector kwargs, polls)
INJECTOR_CASES = {
    "scripted_hard_kill": (4, dict(schedule=[(2, (1,), None)]), 5),
    "short_flap_debounced": (4, dict(schedule=[(1, (2,), 1)],
                                     retry_window=1), 5),
    "long_flap_reported": (4, dict(schedule=[(0, (2,), 4)],
                                   retry_window=1), 6),
    "probabilistic_seeded": (8, dict(p_fail=0.05, p_flap=0.1, seed=3), 30),
    "host_out_of_range": (2, dict(schedule=[(0, (5,), None)]), 1),
}


def _trace(mod, n_hosts, kw, polls):
    kw = dict(kw)
    kw["schedule"] = [mod.FaultScript(step=s, hosts=h, down_for=d)
                      for s, h, d in kw.get("schedule", [])]
    try:
        inj = mod.FaultInjector(n_hosts, **kw)
    except ValueError as e:
        return ("ValueError", str(e))
    events = [[(type(e).__name__, e.kind, e.hosts, e.transient)
               for e in inj.poll()] for _ in range(polls)]
    return (events, inj.dead_hosts, inj.injected_hard, inj.injected_flaps,
            inj.debounced_flaps)


@pytest.mark.parametrize("case", sorted(INJECTOR_CASES))
def test_fault_injector_trace_matches_jax(case):
    n, kw, polls = INJECTOR_CASES[case]
    ours = _trace(faults, n, kw, polls)
    assert ours == _trace(jax_faults, n, kw, polls)
    if case == "scripted_hard_kill":
        assert ours[0][2] == [("HostFailed", "host_failed", (1,), False)]
        assert sum(map(len, ours[0])) == 1 and ours[2] == 1
    elif case == "short_flap_debounced":
        assert not any(ours[0]) and ours[3:] == (1, 1)
    elif case == "long_flap_reported":
        assert ours[0][1] == [("HostFailed", "host_failed", (2,), True)]
        assert ours[0][3] == [("HostFailed", "host_failed", (), True)]
    elif case == "probabilistic_seeded":
        assert any(ours[0])
        assert ours != _trace(faults, n, {**kw, "seed": 4}, polls)
    else:
        assert ours[0] == "ValueError"


# --------------------------------------------------- session hard recovery


class TestSessionHardFailure:
    @pytest.mark.parametrize("kill_at", [1, 3, 5])
    def test_kill_at_any_step_loss_exact(self, tmp_path, kill_at):
        """A hard kill at ANY step recovers to a loss history equal to an
        uninterrupted run on the surviving topology."""
        steps = 6
        ref = make_session(CLUSTER.shrink((1,))).bind()
        ref_hist = [ref.step() for _ in range(steps)]

        mgr = AsyncCheckpointManager(str(tmp_path), every=2, keep=4)
        inj = faults.FaultInjector(
            CLUSTER.n_hosts,
            schedule=[faults.FaultScript(step=kill_at, hosts=(1,))])
        sess = make_session(callbacks=[CheckpointCallbacks(mgr)],
                            event_sources=[inj]).bind()
        hist = [sess.step() for _ in range(steps)]
        mgr.wait()
        mgr.close()

        restores = [r for r in sess.replans if r.mode == "restore"]
        assert len(restores) == 1
        r = restores[0]
        assert r.restored_step is not None
        assert r.rollback_steps == kill_at - r.restored_step
        assert len(hist) == steps and sess.step_count == steps
        assert sess.history == hist
        np.testing.assert_allclose(hist, ref_hist, atol=1e-6)
        assert not _plan_devices(sess) & set(CLUSTER.devices_of(1))

    def test_debounced_flap_no_replan(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), every=1)
        inj = faults.FaultInjector(
            CLUSTER.n_hosts,
            schedule=[faults.FaultScript(step=1, hosts=(1,), down_for=1)],
            retry_window=1)
        sess = make_session(callbacks=[CheckpointCallbacks(mgr)],
                            event_sources=[inj]).bind()
        for _ in range(4):
            sess.step()
        mgr.close()
        assert sess.replans == []
        assert inj.debounced_flaps == 1

    def test_transient_evict_then_restore(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), every=1)
        inj = faults.FaultInjector(
            CLUSTER.n_hosts,
            schedule=[faults.FaultScript(step=1, hosts=(1,), down_for=4)],
            retry_window=1)
        sess = make_session(callbacks=[CheckpointCallbacks(mgr)],
                            event_sources=[inj]).bind()
        for _ in range(8):
            sess.step()
        mgr.close()
        # evicted past the retry window (a rollback), then restored on the
        # heartbeat (a cooperative snapshot and restore)
        assert [r.mode for r in sess.replans] == ["restore", "restore"]
        assert sess.replans[1].rollback_steps == 0
        assert sess.cluster == CLUSTER  # full topology back

    def test_plan_only_checkpoint_warns(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every=1)
        sess = SpindleSession(
            SessionConfig(cluster=CLUSTER, workload="multitask_clip"),
            callbacks=[CheckpointCallbacks(mgr)])
        with pytest.warns(RuntimeWarning, match="plan-only"):
            sess.plan()

    def test_batch_fn_data_cursor_replayed(self, tmp_path):
        """A non-constant data stream: rolling step_count back to the
        snapshot IS the data-cursor restore, so replay stays exact."""
        _, base_batches = tiny_multitask_clip(n_tasks=len(TASKS))
        fetched = []

        def batch_fn(step):
            fetched.append(step)
            return {t: {k: v if not v.is_floating_point()
                        else v * (1 + 0.01 * step) for k, v in b.items()}
                    for t, b in base_batches.items()}

        def mk(cluster, **kw):
            m, _ = tiny_multitask_clip(n_tasks=len(TASKS))
            return SpindleSession(
                SessionConfig(cluster=cluster, device="cpu"),
                model=m, tasks=TASKS, batch_fn=batch_fn, **kw)

        steps, kill_at = 6, 3
        ref = mk(CLUSTER.shrink((1,)))
        ref_hist = [ref.step() for _ in range(steps)]

        mgr = AsyncCheckpointManager(str(tmp_path), every=2, keep=4)
        inj = faults.FaultInjector(
            CLUSTER.n_hosts,
            schedule=[faults.FaultScript(step=kill_at, hosts=(1,))])
        fetched.clear()
        sess = mk(CLUSTER, callbacks=[CheckpointCallbacks(mgr)],
                  event_sources=[inj])
        hist = [sess.step() for _ in range(steps)]
        mgr.close()
        restores = [r for r in sess.replans if r.mode == "restore"]
        assert len(restores) == 1 and restores[0].restored_step == 2
        assert restores[0].rollback_steps == 1
        assert fetched == [0, 1, 2, 3, 3, 4, 5]  # step 3 refetched
        np.testing.assert_allclose(hist, ref_hist, atol=1e-6)

    def test_kill_without_snapshot_warns_and_shrinks(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every=0)  # never saves
        sess = make_session(callbacks=[CheckpointCallbacks(mgr)]).bind()
        sess.run(2)
        with pytest.warns(RuntimeWarning, match="no durable snapshot"):
            sess.signal(HostFailed((1,)))
        rec = sess.replans[-1]
        assert rec.mode != "restore" and rec.restored_step is None
        assert sess.step_count == 2 and not _plan_devices(sess) & set(
            CLUSTER.devices_of(1))

    def test_failed_restore_leaves_live_state(self, tmp_path):
        """The restore builds a new ModuleDict and OptState; a failure in
        the turn leaves the session on its old objects, values and
        cluster (the optimizer updates those in place, so a restore into
        them would leave nothing to roll back to)."""

        class Broken(CheckpointManager):
            def restore_latest(self, tree_like):
                tree, manifest = super().restore_latest(tree_like)
                tree["params"].popitem()  # a leaf the module needs
                return tree, manifest

        mgr = Broken(str(tmp_path), every=2)  # the snapshot is step 0's
        sess = make_session(callbacks=[CheckpointCallbacks(mgr)]).bind()
        sess.run(2)
        params, state = sess.params, sess.opt_state
        before = {k: v.detach().clone()
                  for k, v in params.named_parameters()}
        with pytest.raises(KeyError):
            sess.signal(HostFailed((1,)))
        assert sess.params is params and sess.opt_state is state
        assert sess.cluster == CLUSTER and not sess.replans
        for k, v in params.named_parameters():
            assert torch.equal(v, before[k])


# ------------------------------- tests/test_session.py:234-283, on the port


def _reference_delta(sess):
    ref_l, ref_g = sess.model.reference_loss_and_grads(sess.params,
                                                       sess.batches)
    loss, grads = sess.engine.loss_and_grads(sess.params, sess.batches)
    dg = max(float((grads[n] - g).abs().max()) for n, g in ref_g.items())
    return abs(float(loss) - float(ref_l)), dg


def test_straggler_restore_replan_through_checkpoint(tmp_path):
    """A cluster-changing straggler event on a session with a checkpoint
    manager snapshots, evicts the host and restores: mode "restore", and
    the next loss equals ``reference_loss`` on the snapshot's params."""
    mgr = CheckpointManager(str(tmp_path), every=0)  # periodic off
    sess = make_session(config={"straggler_shrink": True},
                        callbacks=[CheckpointCallbacks(mgr)]).bind()
    sess.run(steps=2)
    live = sess.params

    sess.signal(StragglerDetected((1,)))
    rec = sess.replans[-1]
    assert rec.mode == "restore" and rec.restored_step == 1
    assert rec.plan_mode in ("full", "incremental", "fallback")
    assert rec.rollback_steps == 0 and sess.params is not live
    assert _plan_devices(sess).isdisjoint(CLUSTER.devices_of(1))

    ref, manifest = restore_checkpoint(
        str(tmp_path), {"params": sess.params, "opt": sess.opt_state})
    assert manifest["step"] == 1
    assert ref["opt"].count == sess.opt_state.count == 2
    ref_loss = float(sess.model.reference_loss(
        fresh_module(sess.params, ref["params"]), sess.batches).detach())
    loss = sess.step()
    assert abs(loss - ref_loss) < 1e-6
    dl, dg = _reference_delta(sess)
    assert dl < 1e-6 and dg < 1e-6

    # without a snapshot-capable callback the same event replans WITHOUT
    # the restore mode (a plain topology shrink)
    sess2 = make_session(config={"straggler_shrink": True}).bind()
    sess2.signal(StragglerDetected((1,)))
    assert sess2.replans[-1].mode != "restore"
    assert sess2.replans[-1].restored_step is None


# ---------------------------------------------- parity with the JAX session


def test_kill_at_3_matches_jax_session(tmp_path):
    """A hard kill after step 3 on both packages' sessions, from the same
    (bridged) params and batches and the reference's hardware values: the
    same replan records, restored step, rollback and final plan devices,
    and loss histories within 1e-5."""
    import jax
    import jax.numpy as jnp

    import repro.ckpt as jax_ckpt
    import repro.session as jax_session
    from repro.core.costmodel import V5E
    from repro.core.placement import ClusterSpec as JaxClusterSpec
    from repro.runtime import tiny_multitask_clip as jax_tiny_clip
    from repro_torch import bridge
    from repro_torch.core.costmodel import HardwareSpec

    steps, kill_at = 6, 3

    def injector(mod):
        return mod.FaultInjector(
            CLUSTER.n_hosts,
            schedule=[mod.FaultScript(step=kill_at, hosts=(1,))])

    jmgr = jax_ckpt.AsyncCheckpointManager(str(tmp_path / "jax"), every=2,
                                           keep=4)
    jsess = jax_session.SpindleSession(
        jax_session.SessionConfig(cluster=JaxClusterSpec(**CLUSTER_KW)),
        model_factory=lambda ts: jax_tiny_clip(n_tasks=len(ts)), tasks=TASKS,
        callbacks=[jax_session.CheckpointCallbacks(jmgr)],
        event_sources=[injector(jax_faults)]).bind()
    # the JAX step runs jitted, one trace per plan (eager JAX compiles
    # every op: its first step would take ~25 s)
    engine, eager_step, traced = jsess.engine, jsess.engine.train_step, {}

    def jitted_step(params, opt_state, batches, optimizer, on_wave=None):
        key = id(engine.plan)
        if key not in traced:
            traced[key] = jax.jit(
                lambda p, o, b: eager_step(p, o, b, optimizer))
        return traced[key](params, opt_state, batches)

    engine.train_step = jitted_step
    mgr = AsyncCheckpointManager(str(tmp_path / "port"), every=2, keep=4)
    sess = make_session(
        config={"hw": HardwareSpec(**dataclasses.asdict(V5E))},
        callbacks=[CheckpointCallbacks(mgr)],
        event_sources=[injector(faults)]).bind()
    bridge.load_mt_params(sess.params, jax.tree.map(np.asarray, jsess.params))
    jsess.batches = {t: {k: jnp.asarray(v.numpy()) for k, v in b.items()}
                     for t, b in sess.batches.items()}
    hist = [sess.step() for _ in range(steps)]
    jhist = [jsess.step() for _ in range(steps)]
    mgr.close()
    jmgr.close()

    def records(s):
        return [(r.mode, r.plan_mode, r.event.kind, r.event.hosts,
                 r.restored_step, r.rollback_steps) for r in s.replans]

    assert records(sess) == records(jsess)
    assert [r[0] for r in records(sess)] == ["restore"]
    assert _plan_devices(sess) == _plan_devices(jsess)
    assert sess.step_count == jsess.step_count == steps
    assert len(traced) == 2  # the JAX engine stepped on both plans
    np.testing.assert_allclose(hist, jhist, atol=1e-5)
