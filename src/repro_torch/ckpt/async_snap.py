"""Async double-buffered snapshots: saves run off the step turn (port of
``repro/ckpt/async_snap.py``).

:class:`AsyncCheckpointManager` is a drop-in :class:`CheckpointManager`
whose ``save`` does only the cheap, consistency-critical work on the
caller's turn — copy the tree into host memory — and hands the file I/O
(npz serialization, manifest, atomic publish) to a single background
writer thread.  The hand-off buffer is double-buffered: at most one
snapshot is being written and at most one is pending, and a newer pending
snapshot replaces an older never-started one, so a slow disk can delay
durability but never queue unbounded host copies or stall the training
step.

The copy must be a real one: the port's optimizer updates params and
moments in place (:meth:`repro_torch.optim.AdamW.update`), and a CPU
tensor's ``.to("cpu")`` is the tensor itself, so an aliased snapshot
would silently become the next step's state.  The device-to-host copy is
synchronous (no ``non_blocking``); the writer thread touches numpy arrays
and files only, never the device.

Durability contract: a snapshot is *durable* once the writer's atomic
publish completes — killing the process mid-write leaves only a ``.tmp``
directory that ``latest_step`` never surfaces.  ``wait()`` drains the
writer (pending + in-flight) and re-raises the first writer error;
``restore_latest`` drains first (swallowing writer errors — recovery must
proceed on whatever IS durable) so a restore can never race a save of
the same step.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from .checkpoint import (CheckpointManager, HostTree, _step_dir, host_leaves,
                         save_checkpoint)


def _to_host(tree) -> HostTree:
    """A consistent host copy of ``tree`` (the only work that must happen
    on the step turn): every leaf copied, never aliased."""
    return host_leaves(tree, copy=True)


class AsyncCheckpointManager(CheckpointManager):
    """Periodic snapshots whose file I/O runs on a writer thread."""

    def __init__(self, base: str, *, every: int = 50, keep: int = 3,
                 shard_groups: int = 0):
        super().__init__(base, every=every, keep=keep,
                         shard_groups=shard_groups)
        self._cv = threading.Condition()
        self._pending: Optional[Tuple[int, HostTree, Optional[Dict]]] = None
        self._inflight: Optional[int] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves_started = 0    # hand-offs accepted (incl. replaced)
        self.saves_written = 0    # snapshots made durable by the writer
        self.saves_dropped = 0    # pending snapshots replaced by newer
        #: the writer's seconds from taking a snapshot to its publish
        self.write_seconds: List[float] = []

    # -- step-turn side ----------------------------------------------------

    def save(self, step: int, tree, extra=None) -> str:
        """Copy to host and enqueue; returns the step dir the writer will
        publish (durable only after ``wait()`` or a later drain)."""
        host_tree = _to_host(tree)
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncCheckpointManager is closed")
            if self._pending is not None:
                self.saves_dropped += 1  # double buffer: newest wins
            self._pending = (step, host_tree, extra)
            self.saves_started += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer, name="ckpt-writer", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
        return _step_dir(self.base, step)

    def wait(self, *, raise_errors: bool = True) -> None:
        """Block until no snapshot is pending or in flight."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending is None and self._inflight is None
            )
            err, self._error = self._error, None
        if err is not None and raise_errors:
            raise err

    def restore_latest(self, tree_like):
        # drain, but tolerate writer errors: recovery restores whatever
        # is durable, and atomic publish guarantees that set is intact
        self.wait(raise_errors=False)
        return super().restore_latest(tree_like)

    def close(self) -> None:
        """Drain and stop the writer thread (errors re-raised)."""
        self.wait(raise_errors=False)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            err, self._error = self._error, None
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        if err is not None:
            raise err

    # -- writer side -------------------------------------------------------

    def _writer(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._pending is not None or self._closed
                )
                if self._pending is None:  # closed and drained
                    return
                step, host_tree, extra = self._pending
                self._pending = None
                self._inflight = step
                self._cv.notify_all()
            try:
                t0 = time.perf_counter()
                save_checkpoint(
                    self.base, step, host_tree, extra=extra,
                    keep=self.keep, shard_groups=self.shard_groups,
                )
                with self._cv:
                    self.saves_written += 1
                    self.write_seconds.append(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                with self._cv:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cv:
                    self._inflight = None
                    self._cv.notify_all()
