"""Device placement (Spindle §3.5).

Maps each wave entry (sliced MetaOp) to concrete device ids, wave by wave,
with the paper's three guidelines:

  * **Intra-device-island placement** — prefer devices inside one island
    (an NVLink node, as in the paper).
  * **Prioritize high communication workloads** — entries/data flows with the
    largest inter-wave volume are placed first so they win island locality
    and predecessor overlap.
  * **Device memory balance** — track per-device bytes (params + optimizer +
    activations); prefer the least-loaded devices; co-locate parameter-
    sharing MetaOps; on OOM, fall back to sub-optimal-communication
    placements and, if needed, backtrack bounded-depth into earlier waves.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .contraction import MetaGraph, MetaOp
from .scheduler import Schedule, WaveEntry


@dataclass(frozen=True)
class ClusterSpec:
    """Physical cluster description for placement decisions.

    Besides the flat device range, the spec carries an explicit host
    topology: devices ``[h*host_size, (h+1)*host_size)`` belong to host
    ``h`` (``devices_per_host`` defaults to the island size — one host per
    NVLink node / ICI neighborhood).  For heterogeneous or non-contiguous
    topologies — ragged host sizes, or a fleet *lease* carving a sub-set of
    another cluster's device blocks — ``host_map`` replaces the uniform
    blocking with explicit per-host device-id lists (``host_map[h]`` is
    host ``h``'s devices; ids need not be contiguous or consecutive across
    hosts).  ``flagged_hosts`` marks hosts the straggler detector evicted;
    planning and placement run over :meth:`healthy_devices` only, so a
    flagged host removes *its own* device block — placement routes around
    the hole instead of renumbering a uniformly shrunken range.
    Shrink/restore are value-level (:meth:`shrink` / :meth:`restore`
    return new frozen specs), so a full recovery compares equal to the
    original spec.
    """

    n_devices: int
    island_size: int = 8  # NVLink node / ICI neighborhood
    mem_bytes: float = 80e9  # HBM per device (H100 SXM5: 80 GB)
    intra_island_bw: float = 400e9  # bytes/s (NVLink-class / intra-slice ICI)
    inter_island_bw: float = 50e9  # bytes/s (IB / DCN-class)
    devices_per_host: int = 0  # 0 → island_size (one host per island)
    flagged_hosts: Tuple[int, ...] = ()  # evicted hosts (straggler path)
    #: explicit per-host device lists; () → the uniform contiguous blocking
    host_map: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if not self.host_map:
            return
        hm = tuple(tuple(devs) for devs in self.host_map)
        object.__setattr__(self, "host_map", hm)
        flat = [d for devs in hm for d in devs]
        if len(flat) != len(set(flat)):
            raise ValueError("host_map assigns a device to more than one host")
        if any(not devs for devs in hm):
            raise ValueError("host_map hosts must own at least one device")
        if self.n_devices == 0:
            object.__setattr__(self, "n_devices", len(flat))
        elif self.n_devices != len(flat):
            raise ValueError(
                f"n_devices={self.n_devices} != {len(flat)} devices in "
                f"host_map (pass n_devices=0 to derive it)"
            )

    def all_devices(self) -> Tuple[int, ...]:
        """Every device id in this cluster (ascending)."""
        if self.host_map:
            return tuple(sorted(d for devs in self.host_map for d in devs))
        return tuple(range(self.n_devices))

    def island_of(self, dev: int) -> int:
        return dev // self.island_size

    def islands(self) -> List[List[int]]:
        by_isl: Dict[int, List[int]] = {}
        for d in self.all_devices():
            by_isl.setdefault(self.island_of(d), []).append(d)
        return [by_isl[i] for i in sorted(by_isl)]

    # ------------------------------------------------------- host topology
    @property
    def host_size(self) -> int:
        return self.devices_per_host or self.island_size

    @property
    def n_hosts(self) -> int:
        if self.host_map:
            return len(self.host_map)
        return (self.n_devices + self.host_size - 1) // self.host_size

    def host_of(self, dev: int) -> int:
        if self.host_map:
            for h, devs in enumerate(self.host_map):
                if dev in devs:
                    return h
            raise ValueError(f"device {dev} is not in this cluster's host_map")
        return dev // self.host_size

    def devices_of(self, host: int) -> Tuple[int, ...]:
        """The device block owned by ``host`` (empty for out-of-range ids)."""
        if not 0 <= host < self.n_hosts:
            return ()
        if self.host_map:
            return self.host_map[host]
        return tuple(
            range(
                host * self.host_size,
                min((host + 1) * self.host_size, self.n_devices),
            )
        )

    def hosts(self) -> List[List[int]]:
        """host index → its device-id list (the explicit host→device map)."""
        return [list(self.devices_of(h)) for h in range(self.n_hosts)]

    def healthy_devices(
        self, flagged: Optional[Iterable[int]] = None
    ) -> Tuple[int, ...]:
        """Device ids outside the flagged hosts' blocks (ascending).

        ``flagged`` defaults to this spec's own ``flagged_hosts``."""
        bad: Set[int] = set()
        hosts = self.flagged_hosts if flagged is None else flagged
        for h in hosts:
            bad.update(self.devices_of(h))
        return tuple(d for d in self.all_devices() if d not in bad)

    @property
    def n_healthy(self) -> int:
        return len(self.healthy_devices())

    def shrink(self, flagged: Iterable[int]) -> "ClusterSpec":
        """Evict ``flagged`` hosts: same physical cluster, their device
        blocks excluded from planning/placement.  At least one host must
        stay healthy.  ``shrink(())`` ≡ :meth:`restore`."""
        hosts = tuple(sorted({h for h in flagged if 0 <= h < self.n_hosts}))
        if len(hosts) >= self.n_hosts:
            raise ValueError(
                f"cannot flag all {self.n_hosts} hosts — no devices left"
            )
        return dataclasses.replace(self, flagged_hosts=hosts)

    def restore(self) -> "ClusterSpec":
        """Clear every eviction — compares equal to the pre-shrink spec."""
        return dataclasses.replace(self, flagged_hosts=())


@dataclass
class PlacedEntry:
    wave_index: int
    meta_id: int
    devices: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.devices)


@dataclass
class Placement:
    """Full placement: (wave, meta) -> device tuple, plus diagnostics."""

    entries: Dict[Tuple[int, int], PlacedEntry] = field(default_factory=dict)
    mem_high_water: Dict[int, float] = field(default_factory=dict)
    interwave_bytes_intra: float = 0.0  # moved within an island
    interwave_bytes_inter: float = 0.0  # moved across islands
    interwave_bytes_zero: float = 0.0  # same devices — no movement
    backtracks: int = 0

    def devices_for(self, wave_index: int, meta_id: int) -> Tuple[int, ...]:
        return self.entries[(wave_index, meta_id)].devices

    @property
    def comm_time(self) -> float:
        return self.interwave_bytes_intra + self.interwave_bytes_inter


# --------------------------------------------------------------------------


def _entry_memory(m: MetaOp, e: WaveEntry, optimizer_mult: float = 3.0) -> float:
    """Per-device memory of one wave entry: params(+opt states) + activations."""
    w = m.workload
    params = w.param_bytes * e.l * (1.0 + optimizer_mult)
    acts = w.act_bytes * e.l
    # TP shards both params and activations across the group's tp axis; DP
    # shards activations only (params replicated across dp).
    per_dev = params / max(e.config.tp, 1) + acts / max(e.n, 1)
    return per_dev


def _flow_volume(m: MetaOp) -> float:
    return m.workload.act_bytes


# Wave-ordered placement strategies selectable via ``place(strategy=...)``
# (and, at the pipeline layer, via LocalityPlacementStage).  Keys here place
# entries wave by wave over a shared free-device pool; planners whose waves
# overlap in time (e.g. optimus task blocks) use a dedicated PlacementStage
# in repro_torch.core.pipeline instead.
PLACEMENT_STRATEGIES = ("spindle", "sequential")


def place(
    sched: Schedule,
    mg: MetaGraph,
    cluster: ClusterSpec,
    *,
    strategy: str = "spindle",
    max_backtrack: int = 3,
) -> Placement:
    """Place every wave entry onto devices.

    ``strategy='spindle'`` applies the §3.5 guidelines; ``'sequential'`` is
    the Fig. 10 ablation baseline (assign consecutive device ranges in entry
    order, ignoring locality/memory).
    """
    if strategy not in PLACEMENT_STRATEGIES:
        raise ValueError(
            f"unknown placement strategy {strategy!r}; "
            f"choose from {PLACEMENT_STRATEGIES}"
        )
    pl = Placement()
    healthy = cluster.healthy_devices()
    mem = {d: 0.0 for d in healthy}  # high-water per device
    # Last placement of each MetaOp (for data-flow locality & param reuse).
    last_of_meta: Dict[int, Tuple[int, ...]] = {}
    last_of_group: Dict[str, Tuple[int, ...]] = {}
    preds = mg.predecessors()

    for w in sched.waves:
        free: Set[int] = set(healthy)
        # Continuations (same MetaOp, same width as the previous wave) place
        # first — they can achieve zero-cost flows; then high-communication
        # entries (guideline 2).
        def _order_key(e):
            prev = last_of_meta.get(e.meta_id)
            cont = prev is not None and len(prev) == e.n
            return (not cont, -_flow_volume(mg.meta_ops[e.meta_id]) * e.n)

        order = sorted(w.entries, key=_order_key)
        placed_this_wave: List[Tuple[WaveEntry, Tuple[int, ...]]] = []
        backtracks_left = max_backtrack
        work = list(order)
        idx = 0
        while idx < len(work):
            e = work[idx]
            idx += 1
            m = mg.meta_ops[e.meta_id]
            need = e.n
            if strategy == "sequential":
                devs = tuple(sorted(free))[:need]
            else:
                devs = _pick_devices(
                    e, m, need, free, mem, cluster, last_of_meta, last_of_group, preds
                )
            if len(devs) < need:
                raise RuntimeError(
                    f"wave {w.index}: cannot place MetaOp {e.meta_id} "
                    f"({need} devices, {len(free)} free)"
                )
            per_dev = _entry_memory(m, e)
            # OOM handling: retry with memory-first ordering, then backtrack.
            if any(mem[d] + per_dev > cluster.mem_bytes for d in devs):
                alt = _pick_devices(
                    e,
                    m,
                    need,
                    free,
                    mem,
                    cluster,
                    last_of_meta,
                    last_of_group,
                    preds,
                    memory_first=True,
                )
                if alt and all(mem[d] + per_dev <= cluster.mem_bytes for d in alt):
                    devs = alt
                    pl.backtracks += 1
                elif backtracks_left > 0 and placed_this_wave:
                    # bounded backtrack: undo the least-communicating entry of
                    # this wave and retry it after this one.
                    pl.backtracks += 1
                    backtracks_left -= 1
                    victim, vdevs = placed_this_wave.pop()
                    vm = mg.meta_ops[victim.meta_id]
                    vmem = _entry_memory(vm, victim)
                    for d in vdevs:
                        mem[d] -= vmem
                        free.add(d)
                    del pl.entries[(w.index, victim.meta_id)]
                    work.append(victim)
                    # fall through and place e on the freed pool
                    devs = _pick_devices(
                        e,
                        m,
                        need,
                        free,
                        mem,
                        cluster,
                        last_of_meta,
                        last_of_group,
                        preds,
                        memory_first=True,
                    )
                # if still over budget we accept and report via high-water

            for d in devs:
                mem[d] += per_dev
                free.discard(d)
            pl.entries[(w.index, e.meta_id)] = PlacedEntry(w.index, e.meta_id, devs)
            placed_this_wave.append((e, devs))
            # inter-wave flow accounting vs. the producer's devices
            prev = last_of_meta.get(e.meta_id)
            src_sets = [prev] if prev is not None else [
                last_of_meta[p] for p in preds[e.meta_id] if p in last_of_meta
            ]
            vol = _flow_volume(m)
            for src in src_sets:
                if src is None:
                    continue
                if set(src) & set(devs):
                    overlap = len(set(src) & set(devs)) / max(len(devs), 1)
                    pl.interwave_bytes_zero += vol * overlap
                    vol_rem = vol * (1 - overlap)
                else:
                    vol_rem = vol
                same_island = {cluster.island_of(d) for d in src} & {
                    cluster.island_of(d) for d in devs
                }
                if same_island:
                    pl.interwave_bytes_intra += vol_rem
                else:
                    pl.interwave_bytes_inter += vol_rem
            last_of_meta[e.meta_id] = devs
            if m.param_group:
                last_of_group[m.param_group] = devs

    pl.mem_high_water = mem
    return pl


def _pick_devices(
    e: WaveEntry,
    m: MetaOp,
    need: int,
    free: Set[int],
    mem: Dict[int, float],
    cluster: ClusterSpec,
    last_of_meta: Dict[int, Tuple[int, ...]],
    last_of_group: Dict[str, Tuple[int, ...]],
    preds: Dict[int, Set[int]],
    *,
    memory_first: bool = False,
) -> Tuple[int, ...]:
    """Score free devices per the §3.5 guidelines and take the best ``need``.

    Two-tier preference: data-flow locality (this MetaOp's previous slice +
    its producers) outranks parameter-group co-location — flows move
    activations every wave, while group co-location only saves parameter
    storage/sync, so it must not drag a consumer away from its producer."""
    prev = last_of_meta.get(e.meta_id)
    # Sticky continuation: the same MetaOp keeps its devices between waves
    # whenever they are free and the allocation width is unchanged — the
    # flow then moves zero bytes (§3.5 intra-device preference).
    if prev is not None and len(prev) == need and not memory_first and set(
        prev
    ) <= free:
        return tuple(sorted(prev))
    flow_pref: Set[int] = set(prev or ())
    for p in preds.get(e.meta_id, ()):  # producers of our inputs
        flow_pref |= set(last_of_meta.get(p, ()))
    group_pref: Set[int] = set()
    if m.param_group and m.param_group in last_of_group:
        group_pref = set(last_of_group[m.param_group])
    flow_islands = {cluster.island_of(d) for d in flow_pref}

    def score(d: int) -> Tuple:
        in_flow = d in flow_pref
        in_flow_island = cluster.island_of(d) in flow_islands
        in_group = d in group_pref
        if memory_first:
            return (mem[d], not in_flow, not in_flow_island, not in_group, d)
        return (not in_flow, not in_flow_island, not in_group, mem[d], d)

    ranked = sorted(free, key=score)
    if len(ranked) < need:
        return tuple(ranked)

    # Try to keep the group inside as few islands as possible: greedily take
    # whole islands starting from the best-ranked device's island.
    chosen: List[int] = []
    used_islands: List[int] = []
    pool = set(ranked)
    cursor = 0
    while len(chosen) < need and cursor < len(ranked):
        d = ranked[cursor]
        cursor += 1
        if d not in pool:
            continue
        isl = cluster.island_of(d)
        if isl in used_islands:
            continue
        used_islands.append(isl)
        island_devs = [
            x for x in sorted(pool, key=score) if cluster.island_of(x) == isl
        ]
        take = island_devs[: need - len(chosen)]
        chosen.extend(take)
        pool -= set(take)
    if len(chosen) < need:
        rest = [d for d in ranked if d not in chosen]
        chosen.extend(rest[: need - len(chosen)])
    return tuple(sorted(chosen[:need]))
