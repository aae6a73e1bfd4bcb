"""Lower a :class:`~repro_torch.reliability.specs.ReliabilitySpec` into the
flat tensors the engine consumes (a copy of
:mod:`repro.reliability.compile`). All randomness is numpy's, pre-sampled on
the host with a dedicated seed nibble, so the compiled timeline equals the
reference's bit for bit and the wave loop draws nothing.

The compiled form is a single merged event timeline: ``times [RV]`` f32
strictly increasing, ``deltas [RV, R]`` i64 per-resource capacity deltas.
Down events carry the negative of the failed domain's node counts; the
paired up event restores exactly what was taken. Overlapping domain outages
(a rack failing inside an already-drained zone) are clamped at compile time
so cumulative reliability deltas never push a pool's effective capacity
below zero — the up event then restores only what was actually taken.

Repair-delayed return: zone/rack outages become *repair jobs* served by the
finite crew queue (:func:`repro_torch.core.des.single_station_fifo`, the
exact f64 c-server FIFO, on the host). The up event fires at the
crew's FIFO *finish* time, so under crew saturation capacity return is
queue-delayed — the acceptance criterion the realized timeline shows.

Event times are cast to f32 before merging: the engines compare event times
against the wave clock in f32, so a compile-time f32 grid keeps the
engines' wave selection bit-identical (the same reason controller tick
grids walk in f32).

Repair stragglers: repair service durations stream through
:class:`repro_torch.checkpoint.manager.StragglerMonitor` (threshold x
trailing median), so pathologically slow repairs surface in
``availability_summary``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.manager import StragglerMonitor
from repro_torch.core.des import single_station_fifo
from repro_torch.reliability.specs import ReliabilitySpec

#: seed nibble for reliability sampling (outages use 0xD0, attempts 0xF0,
#: service resampling 0xA5, fleet 0xF1)
SEED_NIBBLE = 0xE7


@dataclasses.dataclass(frozen=True)
class RelEvent:
    """One compiled down/up cycle (host-side record for accounting)."""

    kind: str                 # "zone" | "rack" | "spot"
    zone: int                 # zone index (spot: -1)
    rack: int                 # rack index within zone (zone/spot: -1)
    t_down: float             # outage start (f32 grid)
    t_up: float               # capacity-return time (f32 grid; may be
                              # > horizon — the engines then never see it)
    nodes: np.ndarray         # [R] i64 nodes actually taken (post-clamp)
    repair_wait: float        # crew-queue wait (t_repair_start - t_down); 0
                              # for spot reclaims and unqueued repairs
    straggler: bool = False   # repair flagged by the StragglerMonitor


@dataclasses.dataclass(frozen=True)
class CompiledReliability:
    """Flat tensors + host-side records for one reliability scenario."""

    times: np.ndarray                   # [RV] f32, strictly increasing
    deltas: np.ndarray                  # [RV, R] i64 capacity deltas
    events: Tuple[RelEvent, ...]
    base_caps: np.ndarray               # [R] i64 nominal pool sizes
    spot_nodes: np.ndarray              # [R] i64 preemptible slice sizes
    discount: float                     # spot price multiplier (1.0 = none)
    ckpt_frac: Optional[float]          # retry progress kept (None = off)
    evict_attempts: Optional[np.ndarray]  # [N, T] i64 extra attempts
    repair_waits: np.ndarray            # [n_repairs] f64 crew-queue waits
    repair_depth_max: int               # max jobs waiting on a crew
    n_straggler_repairs: int
    horizon_s: float

    @property
    def n_events(self) -> int:
        return int(self.times.shape[0])

    def cum_deltas(self) -> np.ndarray:
        """[RV, R] cumulative reliability delta after each event (always
        <= 0 per resource: down events are clamped at ``-base_caps``)."""
        return np.cumsum(self.deltas, axis=0)


def check_no_double_apply(reliability, scenario) -> None:
    """Reject configurations that would shrink one failure+retry cycle
    twice: ``FailureModel.fail_holds_frac < 1`` shortens the *failing*
    attempt's hold, ``CheckpointSpec.ckpt_frac`` shortens every *retry*
    attempt — composing both on one experiment double-applies partial
    progress to a single attempt cycle."""
    if reliability is None or scenario is None:
        return
    ckpt = getattr(reliability, "checkpoint", None)
    failures = getattr(scenario, "failures", None)
    if ckpt is None or failures is None:
        return
    if getattr(failures, "fail_holds_frac", 1.0) < 1.0:
        raise ValueError(
            "FailureModel.fail_holds_frac < 1 and CheckpointSpec are both "
            "configured: the two would double-apply partial progress to a "
            "single failure+retry cycle (see repro_torch.reliability.specs). "
            "Model checkpointed recovery with CheckpointSpec alone, or "
            "shortened failing holds with fail_holds_frac alone.")


def _partition(total: np.ndarray, n: int) -> np.ndarray:
    """[R, n] exact even partition of each pool's ``total`` nodes."""
    total = np.asarray(total, np.int64)
    k = np.arange(n + 1, dtype=np.int64)
    edges = total[:, None] * k[None, :] // n
    return np.diff(edges, axis=1)


def compile_reliability(rel: ReliabilitySpec, workload, platform,
                        horizon_s: float, seed: int = 0
                        ) -> CompiledReliability:
    """Sample the full reliability event timeline for one replica.

    ``workload`` may be None (capacity events only — no eviction-attempt
    tensor); pass the *extended* workload (after fleet pool append) so spot
    eviction draws cover retraining pipelines too.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([max(int(seed), 0), SEED_NIBBLE]))
    base = np.asarray(platform.capacities, np.int64)
    nres = base.shape[0]
    horizon = float(horizon_s)

    spot = rel.spot
    spot_nodes = (np.rint(base * spot.frac).astype(np.int64)
                  if spot is not None else np.zeros(nres, np.int64))
    on_demand = base - spot_nodes

    topo, out = rel.topology, rel.outages
    zone_nodes = _partition(on_demand, topo.zones)          # [R, Z]
    affected = np.ones(nres, bool)
    if out is not None and out.resources is not None:
        affected = np.zeros(nres, bool)
        affected[np.asarray(out.resources, np.int64)] = True

    # ----- domain outage arrivals (zone then rack, fixed draw order) -----
    repair_jobs: List[Tuple[float, str, int, int, np.ndarray, float]] = []
    if out is not None:
        for z in range(topo.zones):
            nodes = np.where(affected, zone_nodes[:, z], 0)
            if nodes.sum() <= 0:
                continue
            t = float(rng.exponential(out.zone_mtbf_s))
            while t < horizon:
                dur = float(rng.exponential(
                    rel.repair.repair_time_s
                    if rel.repair is not None
                    and rel.repair.repair_time_s is not None
                    else out.mttr_s))
                repair_jobs.append((t, "zone", z, -1, nodes, dur))
                t += dur + float(rng.exponential(out.zone_mtbf_s))
        for z in range(topo.zones):
            rack_nodes = _partition(zone_nodes[:, z], topo.racks_per_zone)
            for k in range(topo.racks_per_zone):
                nodes = np.where(affected, rack_nodes[:, k], 0)
                if nodes.sum() <= 0:
                    continue
                t = float(rng.exponential(out.rack_mtbf_s))
                while t < horizon:
                    dur = float(rng.exponential(
                        rel.repair.repair_time_s
                        if rel.repair is not None
                        and rel.repair.repair_time_s is not None
                        else out.mttr_s))
                    repair_jobs.append((t, "rack", z, k, nodes, dur))
                    t += dur + float(rng.exponential(out.rack_mtbf_s))

    # ----- finite repair-crew FIFO: up time = crew finish, not t + dur -----
    repair_jobs.sort(key=lambda j: (j[0], j[1], j[2], j[3]))
    events: List[dict] = []
    waits = np.zeros(0, np.float64)
    depth_max = 0
    n_straggler = 0
    if repair_jobs:
        ready = np.array([j[0] for j in repair_jobs], np.float64)
        svc = np.array([j[5] for j in repair_jobs], np.float64)
        if rel.repair is not None:
            start, finish = single_station_fifo(ready, svc, rel.repair.crews)
        else:
            start, finish = ready.copy(), ready + svc
        waits = start - ready
        # max crew-queue depth: jobs with ready <= t < start at any instant
        marks = sorted([(r, +1) for r in ready] + [(s, -1) for s in start])
        depth = 0
        for _, d in marks:
            depth += d
            depth_max = max(depth_max, depth)
        watchdog = StragglerMonitor()
        for i, (t0, kind, z, k, nodes, dur) in enumerate(repair_jobs):
            slow = watchdog.record(i, float(svc[i]))
            n_straggler += int(slow)
            events.append(dict(kind=kind, zone=z, rack=k, t_down=t0,
                               t_up=float(finish[i]), nodes=nodes,
                               wait=float(waits[i]), straggler=slow))

    # ----- spot mass evictions (market reclaim, no crew) -----
    if spot is not None and spot_nodes.sum() > 0:
        t = float(rng.exponential(spot.evict_mtbe_s))
        while t < horizon:
            events.append(dict(kind="spot", zone=-1, rack=-1, t_down=t,
                               t_up=t + spot.reclaim_s, nodes=spot_nodes,
                               wait=0.0, straggler=False))
            t += spot.reclaim_s + float(rng.exponential(spot.evict_mtbe_s))

    # ----- clamp overlap + emit the merged f32 delta timeline -----
    q = float(rel.time_quantum_s)
    for ev in events:
        if q > 0:
            # snap up to the quantum grid (never earlier than sampled);
            # a cycle collapsing to zero duration merges away below
            ev["t_down"] = float(np.ceil(ev["t_down"] / q)) * q
            ev["t_up"] = float(np.ceil(ev["t_up"] / q)) * q
        ev["t_down"] = float(np.float32(ev["t_down"]))
        ev["t_up"] = float(np.float32(ev["t_up"]))
    marks2 = []
    for i, ev in enumerate(events):
        marks2.append((ev["t_down"], 0, i))
        marks2.append((ev["t_up"], 1, i))
    marks2.sort()
    cum = np.zeros(nres, np.int64)
    applied = [None] * len(events)
    rows: List[Tuple[float, np.ndarray]] = []
    for t, phase, i in marks2:
        if phase == 0:
            take = np.minimum(events[i]["nodes"].astype(np.int64),
                              base + cum)       # never drive a pool < 0
            take = np.maximum(take, 0)
            applied[i] = take
            cum -= take
            if t < horizon:
                rows.append((t, -take))
        else:
            cum += applied[i]
            if t < horizon:
                rows.append((t, applied[i]))

    merged: dict = {}
    for t, d in rows:
        merged[t] = merged.get(t, np.zeros(nres, np.int64)) + d
    ts = sorted(t for t, d in merged.items() if np.any(d != 0))
    times = np.asarray(ts, np.float32)
    deltas = (np.stack([merged[t] for t in ts]).astype(np.int64)
              if ts else np.zeros((0, nres), np.int64))
    assert times.shape[0] < 2 or (np.diff(times) > 0).all()

    rel_events = tuple(
        RelEvent(kind=ev["kind"], zone=ev["zone"], rack=ev["rack"],
                 t_down=ev["t_down"], t_up=ev["t_up"],
                 nodes=np.asarray(applied[i], np.int64),
                 repair_wait=ev["wait"], straggler=ev["straggler"])
        for i, ev in enumerate(events))

    # ----- pre-sampled eviction retry attempts (task-level spot effect) ---
    evict_attempts = None
    if spot is not None and workload is not None and spot_nodes.sum() > 0:
        service = workload.service_time(platform.datastore)
        live = workload.task_type >= 0
        p = spot.frac * (1.0 - np.exp(-np.asarray(service, np.float64)
                                      / spot.evict_mtbe_s))
        evict_attempts = rng.binomial(1, np.clip(p, 0.0, 0.95) * live
                                      ).astype(np.int64)

    return CompiledReliability(
        times=times, deltas=deltas, events=rel_events, base_caps=base,
        spot_nodes=spot_nodes,
        discount=float(spot.discount) if spot is not None else 1.0,
        ckpt_frac=(float(rel.checkpoint.ckpt_frac)
                   if rel.checkpoint is not None else None),
        evict_attempts=evict_attempts, repair_waits=waits,
        repair_depth_max=int(depth_max),
        n_straggler_repairs=int(n_straggler), horizon_s=horizon)
