"""The port's engines: ``run(spec, params) -> ExperimentResult`` (mirrors
:mod:`repro.core.engines`).

Callers ask the registry (:func:`get_engine`) for an engine by name and
call it. Four engines ship, the counterparts of the reference's:

  - :class:`NumpyEngine` (``"numpy"``): the exact f64 heap engine
    :func:`repro_torch.core.des.simulate` on the host; replicas and sweep
    grids run one after another. It is the serial yardstick of the batched
    engines.
  - :class:`TorchEngine` (``"torch"``, the reference's ``JaxEngine``): a
    replica ensemble, and a whole sweep grid — every (point, replica) pair
    with its capacities, admission policy and compiled operational
    scenario — becomes one rectangular
    :func:`repro_torch.core.vdes.simulate_ensemble` call on the device
    through :mod:`repro_torch.core.batching`. A ragged platform grid is
    padded with inert pools, as in the reference, and workloads of fewer
    tasks with empty task columns (the reference falls back to its numpy
    engine there; the port keeps such a grid on the device).
  - :class:`TorchCompactEngine` (``"torch-compact"``): the same engine with
    :mod:`repro_torch.core.compaction` in place of the one call: the wave
    loop runs in segments over the live rows. The same results bit for bit.
  - :class:`TorchStreamEngine` (``"torch-stream"``): one replica streamed
    from ``spec.source`` through :func:`repro_torch.stream.stream_simulate`
    in arrival windows. The same results bit for bit as materializing the
    source into ``"torch"``.

Every stage of the reference's wave loop rides the batched call: closed-loop
controllers (``Scenario.controller``), the model lifecycle (``fleet`` +
``trigger``), telemetry probes (``probe``) and reliability timelines
(``reliability``) are stacked per entry, with inert padding rows for the
entries that lack them, so a sweep over any of their axes is still one
``simulate_ensemble`` call. The compaction and streaming engines refuse
reliability, as the reference's do.

Workloads are synthesized from fitted ``SimulationParams`` on the device
(:mod:`repro_torch.core.synthesizer`) unless the spec pins one or names a
``source``, which every engine but ``"torch-stream"`` materializes. Seeds
follow the reference's conventions: a spec's replicas are drawn in order
from one ``torch.Generator`` seeded ``spec.seed`` (where the reference
splits ``PRNGKey(seed)``), and replica ``r``'s scenario, fleet and
reliability compile with seed ``spec.seed + 1000 r``. Those draws are
numpy's (except a fleet's retraining-pool durations when they are not
pinned), so on a pinned integer-time workload the summaries equal the
reference engines' exactly. The generator's streams differ between the
CPU and the card, so ``"numpy"`` and ``"torch"`` simulate the same
workloads only when given the same device.

An engine runs on the card unless it was asked for another device
(``get_engine(name, device)``); with no card it raises. ``"numpy"``
synthesizes and compiles there and simulates on the host.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import List, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import batching, des, trace, vdes
from repro_torch.core import model as M
from repro_torch.core.synthesizer import synthesize_workload
from repro_torch.device import resolve_device


@runtime_checkable
class Engine(Protocol):
    """One dispatch point for every simulation backend (the reference's
    protocol): each registered engine has these three members."""

    name: str

    def run(self, spec, params=None):
        """Run one :class:`ExperimentSpec` -> :class:`ExperimentResult`."""
        ...

    def run_sweep(self, specs: Sequence, params=None) -> List:
        """Run a grid of specs, one result per spec (order preserved)."""
        ...


def _check_source(spec) -> None:
    """A spec's ``source`` must be a :class:`~repro_torch.stream.
    TraceSource` (a re-iterable ``blocks()`` stream)."""
    from repro_torch.stream.sources import TraceSource
    if spec.source is not None and not isinstance(spec.source, TraceSource):
        raise TypeError("ExperimentSpec.source must be a TraceSource (a "
                        "name and a re-iterable blocks() stream), got "
                        f"{type(spec.source).__name__}")


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _pad_platform(plat: M.PlatformConfig, nres: int) -> M.PlatformConfig:
    """Pad a platform to ``nres`` resources with inert pools (zero capacity,
    zero cost rate): nothing routes to them, nothing is provisioned on them,
    and they cost nothing — so a ragged platform grid shares one
    rectangular ``[B, nres]`` batch without changing any point's physics
    or accounting."""
    pad = nres - len(plat.resources)
    if pad <= 0:
        return plat
    extra = tuple(
        M.ResourceConfig(name=f"__pad{len(plat.resources) + i}",
                         capacity=0, cost_per_node_hour=0.0)
        for i in range(pad))
    return dataclasses.replace(plat, resources=tuple(plat.resources) + extra)


def _workload_key(spec):
    """Grid points that differ only in capacities/policy/scenario draw the
    *same* workloads; this key lets a sweep synthesize each distinct set
    once (capacity never enters synthesis — only routing and datastore
    parameters do)."""
    return (spec.horizon_s, spec.interarrival_factor, spec.seed,
            spec.n_replicas, tuple(sorted(spec.platform.routing.items())),
            dataclasses.astuple(spec.platform.datastore))


def _fold_reliability(comp, rel_c, w, plat):
    """Fold one replica's compiled reliability *task-level* effects into
    its compiled scenario: presampled spot-eviction retries add to the
    ``attempts`` tensor, and a CheckpointSpec scales every retry slot of
    ``attempt_service`` by ``1 - ckpt_frac`` (in f32, as the reference).
    Capacity-level events ride the separate reliability inputs. Returns
    ``comp`` unchanged when the reliability has no task effects; a
    scenario-less spec gets the inert placeholder scenario first."""
    if rel_c is None:
        return comp
    ev, ck = rel_c.evict_attempts, rel_c.ckpt_frac
    if ev is None and ck is None:
        return comp
    if comp is None:
        from repro_torch.ops.capacity import static_schedule
        from repro_torch.ops.scenario import CompiledScenario
        comp = CompiledScenario(
            schedule=static_schedule(plat.capacities),
            attempts=np.ones(w.task_type.shape, np.int64),
            backoff=vdes._NO_RETRY_BACKOFF)
    att = np.asarray(comp.attempts, np.int64)
    if ev is not None:
        att = att + np.asarray(ev, np.int64)
    asv = comp.attempt_service
    if ck is not None:
        A = int(max(int(att.max()),
                    asv.shape[2] if asv is not None else 0))
        if A > 1:
            if asv is None:
                base = np.asarray(w.service_time(plat.datastore),
                                  np.float64)
                asv = np.repeat(base[..., None], A, -1)
            elif asv.shape[2] < A:
                # the engine clips the attempt index at A-1: repeating the
                # last slot preserves the entry's semantics exactly
                asv = np.concatenate(
                    [asv, np.repeat(asv[..., -1:], A - asv.shape[2], -1)],
                    -1)
            asv = np.asarray(asv, np.float64).copy()
            asv[..., 1:] = (asv[..., 1:].astype(np.float32)
                            * np.float32(1.0 - ck)).astype(np.float64)
    return dataclasses.replace(comp, attempts=att, attempt_service=asv)


def _spec_workloads(spec, params, device, cache=None):
    """The spec's replica workloads, per-replica compiled scenarios and
    compiled fleets, the spec's compiled probe (None without a
    :class:`~repro_torch.obs.probes.ProbeSpec`; one compile covers every
    replica) and per-replica compiled reliability timelines, in the
    reference's order: a fleet extends each workload with its latent
    retraining pool before reliability and the scenario compile, so their
    draws cover the retraining pipelines too. ``cache`` (a dict) shares
    synthesis across grid points whose workload axes agree."""
    _check_source(spec)
    if spec.workload is not None:
        wls = [spec.workload] * spec.n_replicas
    elif spec.source is not None:
        # the batched engines run a source as a pinned workload: the whole
        # stream materialized once (re-iteration is deterministic, so this
        # is what the stream engine consumes window by window)
        from repro_torch.stream import materialize
        wls = [materialize(spec.source)] * spec.n_replicas
    else:
        if params is None:
            raise ValueError("params required unless spec.workload is set")
        key = _workload_key(spec) if cache is not None else None
        if key is not None and key in cache:
            wls = cache[key]
        else:
            gen = torch.Generator(device).manual_seed(int(spec.seed))
            wls = [synthesize_workload(params, gen, spec.horizon_s,
                                       spec.platform,
                                       spec.interarrival_factor)
                   for _ in range(spec.n_replicas)]
            if key is not None:
                cache[key] = wls
    fleets = None
    if spec.fleet is not None:
        from repro_torch.core.runtime import TriggerSpec
        from repro_torch.ops.scenario import compile_fleet
        trig = spec.trigger if spec.trigger is not None else TriggerSpec()
        fleets, ext = [], []
        for r, w in enumerate(wls):
            cf, w2 = compile_fleet(spec.fleet, trig, w, spec.platform,
                                   spec.horizon_s,
                                   seed=spec.seed + 1000 * r, params=params)
            fleets.append(cf)
            ext.append(w2)
        wls = ext
    rels = None
    if spec.reliability is not None:
        from repro_torch.reliability import (check_no_double_apply,
                                             compile_reliability)
        check_no_double_apply(spec.reliability, spec.scenario)
        rels = [compile_reliability(spec.reliability, w, spec.platform,
                                    spec.horizon_s,
                                    seed=spec.seed + 1000 * r)
                for r, w in enumerate(wls)]
    compiled = None
    if spec.scenario is not None:
        compiled = [spec.scenario.compile(w, spec.platform, spec.horizon_s,
                                          seed=spec.seed + 1000 * r,
                                          policy=spec.policy, device=device)
                    for r, w in enumerate(wls)]
    if rels is not None:
        compiled = [_fold_reliability(
            compiled[r] if compiled is not None else None, rels[r], w,
            spec.platform) for r, w in enumerate(wls)]
        if all(c is None for c in compiled):
            compiled = None
    probe = None
    if spec.probe is not None:
        from repro_torch.obs.probes import compile_probe
        probe = compile_probe(
            spec.probe, spec.horizon_s,
            n_models=fleets[0].n_models if fleets is not None else 0)
    return wls, compiled, fleets, probe, rels


def _summarize(spec, rec, compiled, tr, rel=None):
    """Summary for one replica. Under closed-loop control or reliability
    events, cost/utilization integrate the *realized* capacity schedule
    (the engine-recorded timelines on ``tr``); the fleet columns fold in as
    the ``lifecycle`` block and ``rel`` (the replica's compiled
    reliability) as the ``availability`` block."""
    from repro_torch.ops import accounting
    realized = None
    if compiled is not None:
        realized = accounting.realized_schedule(tr, compiled)
        if realized is compiled.schedule:
            realized = None            # planned == realized
    lifecycle = (accounting.lifecycle_summary(tr)
                 if tr.fleet_perf is not None else None)
    s = trace.summarize(
        rec, spec.platform.capacities, spec.horizon_s,
        schedule=compiled.schedule if compiled is not None else None,
        cost_rates=spec.platform.cost_rates if compiled is not None else None,
        slo=spec.scenario.slo if spec.scenario is not None else None,
        realized=realized, lifecycle=lifecycle)
    if rel is not None:
        s["availability"] = accounting.availability_summary(
            rel, spec.platform, tr=tr)
    return s


def _probe_timeline(spec, tr):
    """The result's telemetry view (None for unprobed runs)."""
    if tr.probe_vals is None:
        return None
    from repro_torch.obs.probes import ProbeTimeline
    return ProbeTimeline.from_trace(tr, spec.platform)


def _single_result(spec, rec, summary, tr, wall):
    from repro_torch.core.experiment import ExperimentResult
    from repro_torch.core.runtime import lifecycle_result
    summary["wall_s"] = wall
    summary["pipelines_per_s"] = summary["n_pipelines"] / max(wall, 1e-9)
    return ExperimentResult(spec, summary, rec, wall,
                            lifecycle=lifecycle_result(tr),
                            timeline=_probe_timeline(spec, tr))


def _aggregate_replicas(spec, rep_sums, recs, wall):
    """Monte-Carlo summary across replicas."""
    from repro_torch.core.experiment import ExperimentResult
    summary = {
        "mean_wait_s": float(np.mean([s["mean_wait_s"] for s in rep_sums])),
        "p95_wait_s": float(np.mean([s["p95_wait_s"] for s in rep_sums])),
        "wait_ci95_halfwidth": float(1.96 * np.std(
            [s["mean_wait_s"] for s in rep_sums]) / np.sqrt(len(rep_sums))),
        "wall_s": wall,
        "n_replicas": len(rep_sums),
    }
    for k in ("total_cost", "deadline_miss_rate", "wait_slo_violation_rate",
              "mean_attempts", "planned_total_cost",
              "realized_vs_planned_cost_delta", "mean_staleness",
              "staleness_integral_s", "n_retrained", "n_triggered"):
        if all(k in s for s in rep_sums):
            summary[k] = float(np.mean([s[k] for s in rep_sums]))
    return ExperimentResult(spec, summary, trace.concat_records(recs), wall,
                            rep_sums)


# ---------------------------------------------------------------------------
# numpy: the exact serial engine
# ---------------------------------------------------------------------------

class NumpyEngine:
    """The exact f64 heap engine (:func:`repro_torch.core.des.simulate`):
    replicas and grids run one after another on the host. Workloads are
    synthesized and compiled on the engine's device (``None``: the card,
    resolved when it runs)."""

    name = "numpy"

    def __init__(self, device=None):
        self._device = device

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def run(self, spec, params=None):
        """Run one :class:`ExperimentSpec` -> :class:`ExperimentResult`."""
        return self.run_sweep([spec], params)[0]

    def run_sweep(self, specs: Sequence, params=None) -> List:
        """Run a grid one spec after another; one synthesis cache for the
        whole grid, as the batched engines share it."""
        dev = self.device
        if params is not None and any(s.workload is None for s in specs):
            params = params.to(dev)
        cache = {}
        return [self._run(s, params, dev, cache) for s in specs]

    def _run(self, spec, params, dev, cache):
        t0 = time.perf_counter()
        wls, compiled, fleets, probe, rels = _spec_workloads(
            spec, params, dev, cache=cache)
        recs, sums, trs = [], [], []
        for r, w in enumerate(wls):
            comp = compiled[r] if compiled is not None else None
            rel = rels[r] if rels is not None else None
            tr = des.simulate(w, spec.platform, spec.policy, scenario=comp,
                              fleet=fleets[r] if fleets is not None else None,
                              probe=probe, reliability=rel)
            # a single replica's wall stops at the engine, an ensemble's
            # after its summaries, as in the reference
            wall = time.perf_counter() - t0
            trs.append(tr)
            recs.append(trace.flatten_trace(tr, w))
            sums.append(_summarize(spec, recs[-1], comp, tr, rel=rel))
        if spec.n_replicas == 1:
            return _single_result(spec, recs[0], sums[0], trs[0], wall)
        return _aggregate_replicas(spec, sums, recs,
                                   time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the engine: everything lowers to one simulate_ensemble call
# ---------------------------------------------------------------------------

class TorchEngine:
    """Batched engine on one device (``None``: the card, resolved when it
    runs); an ensemble or a sweep grid is one ``simulate_ensemble``
    call."""

    name = "torch"

    def __init__(self, device=None):
        self._device = device

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _ensemble(self, **kwargs):
        """The one batched call; :class:`TorchCompactEngine` puts the
        segmented compaction driver here. Everything around it — padding,
        stacking, result slicing — is shared."""
        return vdes.simulate_ensemble(**kwargs)

    def run(self, spec, params=None):
        """Run one :class:`ExperimentSpec` -> :class:`ExperimentResult`."""
        return self.run_sweep([spec], params)[0]

    def run_sweep(self, specs: Sequence, params=None) -> List:
        """Lower the whole grid — every (point, replica) pair — into one
        ``vdes.simulate_ensemble`` call: capacities ride ``capacities
        [B, nres]``, policies ``policies [B]``, scenarios and controllers
        the stacked schedule/attempt/ControllerParams tensors, fleets,
        probes and reliability timelines their stacked stage tensors.
        Results come back in order."""
        dev = self.device
        t0 = time.perf_counter()
        if params is not None and any(s.workload is None for s in specs):
            params = params.to(dev)
        nres = {len(s.platform.resources) for s in specs}
        exec_specs = list(specs)
        if len(nres) != 1:
            # ragged platform grid: pad every point to the superset so ONE
            # rectangular batch covers it
            exec_specs = [dataclasses.replace(
                s, platform=_pad_platform(s.platform, max(nres)))
                for s in specs]

        entries = []   # (spec index, workload, compiled, fleet, probe, rel)
        wl_cache = {}   # distinct workloads synthesized once for the grid
        for g, spec in enumerate(exec_specs):
            wls, compiled, fleets, probe, rels = _spec_workloads(
                spec, params, dev, cache=wl_cache)
            entries += [(g, w, compiled[r] if compiled is not None else None,
                         fleets[r] if fleets is not None else None, probe,
                         rels[r] if rels is not None else None)
                        for r, w in enumerate(wls)]

        plats = [exec_specs[g].platform for g, *_ in entries]
        # workloads of fewer tasks get empty task columns: one batch
        cols = batching.pad_workloads([w for _, w, *_ in entries], plats)
        n_max = cols["n_max"]
        caps = np.stack([p.capacities for p in plats]).astype(np.int32)
        pol = np.array([exec_specs[g].policy for g, *_ in entries],
                       np.int32)
        if any(c is not None for _, _, c, *_ in entries):
            from repro_torch.ops.capacity import static_schedule
            from repro_torch.ops.scenario import CompiledScenario
            comps = [c if c is not None else CompiledScenario(
                        schedule=static_schedule(
                            exec_specs[g].platform.capacities),
                        attempts=np.ones(w.task_type.shape, np.int64),
                        backoff=vdes._NO_RETRY_BACKOFF)
                     for g, w, c, *_ in entries]
            services = [cols["service"][i][: w.n]
                        for i, (_, w, *_) in enumerate(entries)]
            cols.update(batching.stack_scenarios(
                comps, n_max, max(s.horizon_s for s in specs),
                services=services))
        # stage tensors: entries without a stage get its inert padding row
        fleets = [f for _, _, _, f, _, _ in entries]
        cols.update(batching.stack_fleets(fleets, n_max))
        cols.update(batching.stack_probes([p for *_, p, _ in entries],
                                          fleets))
        cols.update(batching.stack_reliability([r for *_, r in entries]))
        out = self._ensemble(
            **batching.to_tensors(cols, dev), capacities=caps,
            policy=int(pol[0]),
            policies=None if bool((pol == pol[0]).all()) else pol,
            device=dev)
        out = {k: v.cpu() for k, v in out.items()}
        wall = time.perf_counter() - t0

        results, i = [], 0
        for g, spec in enumerate(specs):
            recs, sums, trs = [], [], []
            for r in range(spec.n_replicas):
                _, wl, comp, fl, pr, rl = entries[i + r]
                tr = batching.batch_trace(out, i + r, wl,
                                          spec.platform.capacities,
                                          with_scenario=comp is not None,
                                          fleet=fl, probe=pr,
                                          reliability=rl)
                trs.append(tr)
                recs.append(trace.flatten_trace(tr, wl))
                # against the executed (possibly padded) platform, so the
                # cost/schedule tensors line up; padded pools add zero
                sums.append(_summarize(exec_specs[g], recs[-1], comp, tr,
                                       rel=rl))
            i += spec.n_replicas
            if spec.n_replicas == 1:
                results.append(_single_result(spec, recs[0], sums[0], trs[0],
                                              wall))
            else:
                results.append(_aggregate_replicas(spec, sums, recs, wall))
        return results


class TorchCompactEngine(TorchEngine):
    """The batched engine with active-set compaction
    (:mod:`repro_torch.core.compaction`): the wave loop runs in windowed
    segments, finished replicas leave the batch axis, DONE pipelines are
    gathered out of the working set and not-yet-arrived pipelines wait past
    a per-segment time guard (power-of-two widths). Bit for bit
    :class:`TorchEngine`'s results; only the wall differs. The admission
    stage runs ``fused_admission`` on the card (``admission_sort=
    "kernel"``)."""

    name = "torch-compact"

    def __init__(self, segment_waves: int = 256, drain_waves: int = 256,
                 min_rows: int = 8, lookahead: int = 24,
                 admission_sort: str = "kernel", device=None):
        super().__init__(device)
        self.segment_waves = segment_waves
        self.drain_waves = drain_waves
        self.min_rows = min_rows
        self.lookahead = lookahead
        self.admission_sort = admission_sort
        self.last_log = None     # CompactionLog of the most recent sweep

    def _ensemble(self, **kwargs):
        from repro_torch.core.compaction import (CompactionLog,
                                                 simulate_ensemble_compacted)
        if "rel_times" in kwargs:
            raise NotImplementedError(
                "reliability event timelines are not supported by the "
                "segmented compaction driver; run reliability specs on the "
                "'torch' (one-call batched) or 'numpy' engine")
        kwargs.setdefault("admission_sort", self.admission_sort)
        self.last_log = CompactionLog()
        return simulate_ensemble_compacted(
            segment_waves=self.segment_waves, drain_waves=self.drain_waves,
            min_rows=self.min_rows, lookahead=self.lookahead,
            log=self.last_log, **kwargs)

    def run_sweep(self, specs: Sequence, params=None) -> List:
        results = super().run_sweep(specs, params)
        if self.last_log is not None:
            for res in results:
                res.summary["n_compactions"] = self.last_log.n_compactions
                res.summary["compaction_segments"] = self.last_log.n_segments
        return results


class TorchStreamEngine:
    """Streaming engine (``"torch-stream"``): consumes ``spec.source`` (a
    :class:`~repro_torch.stream.TraceSource`) through
    :func:`repro_torch.stream.stream_simulate`: the wave loop runs in
    resumable arrival windows, retired pipelines leave the working set at
    window boundaries, and ingestion (synthesis, failure draws, staging)
    overlaps the device step. Bit for bit the results of materializing the
    stream into ``"torch"``.

    Specs without a ``source`` stream their own synthetic workload from
    ``(params, seed, horizon)`` through a
    :class:`~repro_torch.stream.SyntheticSource`. Its blockwise draws differ
    from one-shot ``synthesize_workload``'s, so set an explicit ``source``
    to compare engines. One replica only; reliability is refused."""

    name = "torch-stream"

    def __init__(self, window_s=None, overlap: bool = True,
                 min_rows: int = 64, admission_sort: str = "kernel",
                 device=None):
        self._device = device
        self.window_s = window_s
        self.overlap = overlap
        self.min_rows = min_rows
        self.admission_sort = admission_sort
        self.last_result = None       # StreamResult of the most recent run

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _source(self, spec, params):
        _check_source(spec)
        if spec.source is not None:
            return spec.source
        if spec.workload is not None:
            raise ValueError(
                "torch-stream streams a TraceSource; wrap the pinned "
                "workload in a source (or use engine='torch' for pinned "
                "workloads)")
        if params is None:
            raise ValueError("params required unless spec.source is set")
        from repro_torch.stream import SyntheticSource
        return SyntheticSource(params, platform=spec.platform,
                               seed=spec.seed, until_s=spec.horizon_s,
                               interarrival_factor=spec.interarrival_factor,
                               device=self.device)

    def run(self, spec, params=None):
        if spec.n_replicas != 1:
            raise ValueError(
                "torch-stream is a single-replica engine (a stream has one "
                "realization); use n_replicas=1 or the 'torch' engine")
        if spec.reliability is not None:
            raise ValueError(
                "torch-stream does not support reliability specs (event "
                "timelines span windows); use the 'torch' or 'numpy' engine")
        from repro_torch.core.experiment import ExperimentResult
        from repro_torch.stream import stream_simulate
        dev = self.device
        if params is not None:
            params = params.to(dev)
        sr = stream_simulate(
            self._source(spec, params), spec.platform, policy=spec.policy,
            scenario=spec.scenario, fleet=spec.fleet, trigger=spec.trigger,
            probe=spec.probe, horizon_s=spec.horizon_s,
            window_s=self.window_s, seed=spec.seed, params=params,
            overlap=self.overlap, min_rows=self.min_rows,
            admission_sort=self.admission_sort, device=dev)
        self.last_result = sr
        summary = dict(sr.summary)
        summary["pipelines_per_s"] = sr.n_pipelines / max(sr.wall_s, 1e-9)
        return ExperimentResult(spec, summary, sr.records, sr.wall_s)

    def run_sweep(self, specs: Sequence, params=None) -> List:
        # streams are stateful and windowed: a grid runs one at a time
        return [self.run(s, params) for s in specs]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_ENGINES = {}


def register_engine(engine) -> None:
    _ENGINES[engine.name] = engine


def get_engine(name: str, device=None):
    """The registered engine ``name``; with ``device``, a copy that runs
    there (``None``: the card). An unknown name raises ``ValueError``."""
    try:
        eng = _ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; registered: "
                         f"{sorted(_ENGINES)}") from None
    if device is not None:
        eng = copy.copy(eng)
        eng._device = device
    return eng


register_engine(NumpyEngine())
register_engine(TorchEngine())
register_engine(TorchCompactEngine())
register_engine(TorchStreamEngine())
