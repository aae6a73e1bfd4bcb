"""The port's engine: ``run(spec, params) -> ExperimentResult`` (mirrors
:mod:`repro.core.engines`).

The reference ships several engines behind a registry; the port has one,
:class:`TorchEngine`, the counterpart of the reference's batched
``JaxEngine``. A replica ensemble, and a whole sweep grid — every (point,
replica) pair with its capacities, admission policy and compiled
operational scenario — becomes one rectangular
:func:`repro_torch.core.vdes.simulate_ensemble` call on the device through
:mod:`repro_torch.core.batching`. A ragged platform grid is padded with
inert pools, as in the reference.

Workloads are synthesized from fitted ``SimulationParams`` on the device
(:mod:`repro_torch.core.synthesizer`) unless the spec pins one. Seeds follow
the reference's conventions: a spec's replicas are drawn in order from one
``torch.Generator`` seeded ``spec.seed`` (where the reference splits
``PRNGKey(seed)``), and replica ``r``'s scenario compiles with seed
``spec.seed + 1000 r``. The scenario draws are numpy's, so on a pinned
integer-time workload the summaries equal the reference engines' exactly.

The stages this port does not have yet are refused loudly: a fleet,
probe, reliability, ``source`` or scenario controller on a spec raises
``NotImplementedError``. Nothing is registered in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import batching, trace, vdes
from repro_torch.core import model as M
from repro_torch.core.synthesizer import synthesize_workload
from repro_torch.device import resolve_device

ENGINE_NAME = "torch"
# spec fields of engine stages that are not ported yet
_UNPORTED_FIELDS = ("fleet", "probe", "reliability", "source")


def check_ported(spec) -> None:
    """Raise for a spec that needs a stage this port does not have."""
    if spec.engine != ENGINE_NAME:
        raise ValueError(f"repro_torch has one engine, {ENGINE_NAME!r}; got "
                         f"engine={spec.engine!r}")
    for f in _UNPORTED_FIELDS:
        if getattr(spec, f, None) is not None:
            raise NotImplementedError(
                f"ExperimentSpec.{f}: that engine stage is not ported to "
                "repro_torch yet; run it on the reference engines")
    if getattr(spec.scenario, "controller", None) is not None:
        raise NotImplementedError(
            "a scenario controller: the closed-loop control stage is not "
            "ported to repro_torch yet")


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


def _spec_workloads(spec, params, device, cache=None):
    """The spec's replica workloads and per-replica compiled scenarios
    (None without a scenario). ``cache`` (a dict) shares synthesis across
    grid points whose workload axes agree."""
    if spec.workload is not None:
        wls = [spec.workload] * spec.n_replicas
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
    compiled = None
    if spec.scenario is not None:
        compiled = [spec.scenario.compile(w, spec.platform, spec.horizon_s,
                                          seed=spec.seed + 1000 * r,
                                          policy=spec.policy)
                    for r, w in enumerate(wls)]
    return wls, compiled


def _summarize(spec, rec, compiled):
    """Summary for one replica, with the scenario's cost/SLO accounting."""
    return trace.summarize(
        rec, spec.platform.capacities, spec.horizon_s,
        schedule=compiled.schedule if compiled is not None else None,
        cost_rates=spec.platform.cost_rates if compiled is not None else None,
        slo=spec.scenario.slo if spec.scenario is not None else None)


def _single_result(spec, rec, summary, wall):
    from repro_torch.core.experiment import ExperimentResult
    summary["wall_s"] = wall
    summary["pipelines_per_s"] = summary["n_pipelines"] / max(wall, 1e-9)
    return ExperimentResult(spec, summary, rec, wall)


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
# the engine: everything lowers to one simulate_ensemble call
# ---------------------------------------------------------------------------

class TorchEngine:
    """Batched engine on one device (``None``: the card); an ensemble or a
    sweep grid is one ``simulate_ensemble`` call."""

    name = ENGINE_NAME

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def run(self, spec, params=None):
        """Run one :class:`ExperimentSpec` -> :class:`ExperimentResult`."""
        return self.run_sweep([spec], params)[0]

    def run_sweep(self, specs: Sequence, params=None) -> List:
        """Lower the whole grid — every (point, replica) pair — into one
        ``vdes.simulate_ensemble`` call: capacities ride ``capacities
        [B, nres]``, policies ``policies [B]``, scenarios the stacked
        schedule/attempt tensors. Results come back in order."""
        for s in specs:
            check_ported(s)
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

        entries = []    # (spec index, workload, compiled scenario)
        wl_cache = {}   # distinct workloads synthesized once for the grid
        for g, spec in enumerate(exec_specs):
            wls, compiled = _spec_workloads(spec, params, dev, cache=wl_cache)
            entries += [(g, w, compiled[r] if compiled is not None else None)
                        for r, w in enumerate(wls)]

        plats = [exec_specs[g].platform for g, _, _ in entries]
        cols = batching.pad_workloads([w for _, w, _ in entries], plats)
        n_max = cols["n_max"]
        caps = np.stack([p.capacities for p in plats]).astype(np.int32)
        pol = np.array([exec_specs[g].policy for g, _, _ in entries],
                       np.int32)
        if any(c is not None for _, _, c in entries):
            from repro_torch.ops.capacity import static_schedule
            from repro_torch.ops.scenario import CompiledScenario
            comps = [c if c is not None else CompiledScenario(
                        schedule=static_schedule(
                            exec_specs[g].platform.capacities),
                        attempts=np.ones(w.task_type.shape, np.int64),
                        backoff=vdes._NO_RETRY_BACKOFF)
                     for g, w, c in entries]
            services = [cols["service"][i][: w.n]
                        for i, (_, w, _) in enumerate(entries)]
            cols.update(batching.stack_scenarios(
                comps, n_max, max(s.horizon_s for s in specs),
                services=services))
        out = vdes.simulate_ensemble(
            **batching.to_tensors(cols, dev), capacities=caps,
            policy=int(pol[0]),
            policies=None if bool((pol == pol[0]).all()) else pol,
            device=dev)
        out = {k: v.cpu() for k, v in out.items()}
        wall = time.perf_counter() - t0

        results, i = [], 0
        for g, spec in enumerate(specs):
            recs, sums = [], []
            for r in range(spec.n_replicas):
                _, wl, comp = entries[i + r]
                tr = batching.batch_trace(out, i + r, wl,
                                          spec.platform.capacities,
                                          with_scenario=comp is not None)
                recs.append(trace.flatten_trace(tr, wl))
                # against the executed (possibly padded) platform, so the
                # cost/schedule tensors line up; padded pools add zero
                sums.append(_summarize(exec_specs[g], recs[-1], comp))
            i += spec.n_replicas
            if spec.n_replicas == 1:
                results.append(_single_result(spec, recs[0], sums[0], wall))
            else:
                results.append(_aggregate_replicas(spec, sums, recs, wall))
        return results
