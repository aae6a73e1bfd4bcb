"""Declarative experiment API (mirrors :mod:`repro.core.experiment`; paper
§IV: "The main entry point for users is to define an experiment and its
parameters, systematically mutating them in an iterative, exploratory
process").

:class:`ExperimentSpec` is inert data: a full
:class:`~repro_torch.core.model.PlatformConfig`, workload parameters, an
admission policy, an operational
:class:`~repro_torch.ops.scenario.Scenario`, and replication/seed control.
It keeps the reference's fields: ``fleet`` + ``trigger`` (the model
lifecycle, Fig 7), ``probe`` (in-loop telemetry) and ``reliability``
(correlated outages, repair crews, spot eviction) run in the engine's wave
loop; ``source`` (a :class:`~repro_torch.stream.TraceSource`) is streamed
window by window by the ``"torch-stream"`` engine and materialized into a
pinned workload by the others. ``engine`` names a registered engine
(:func:`repro_torch.core.engines.get_engine`): ``"torch"``,
``"torch-compact"``, ``"torch-stream"`` or ``"numpy"``.

:class:`Sweep` composes a spec with named axes (spec fields,
``"capacity:<resource>"``, ``"trigger:*"``, ``"fleet:*"``, ``"probe:*"``
and ``"reliability:*"`` shorthands, closed-loop ``"controller"`` gains,
scenarios, policies, seeds) into a Cartesian grid that runs as ONE batched
``simulate_ensemble`` call on the batched engines.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import des, trace
from repro_torch.core import model as M
from repro_torch.core.fitting import SimulationParams
from repro_torch.core.runtime import FleetSpec, TriggerSpec

if TYPE_CHECKING:
    from repro_torch.ops.scenario import Scenario

_UNSET = object()   # sentinel: "controller" axis absent vs explicitly None


@dataclasses.dataclass
class ExperimentSpec:
    """A declarative experiment over an arbitrary platform. ``workload``
    optionally pins a pre-materialized :class:`~repro_torch.core.model.
    Workload` (then no synthesis happens and ``interarrival_factor`` is
    ignored) — the hook parity tests and trace replays use.

    ``fleet`` + ``trigger`` declare the run-time view (Fig 7): a fleet of
    deployed models under drift and the trigger that retrains them, run in
    the engine's fleet stage (``trigger`` defaults to ``TriggerSpec()`` when
    a fleet is set; without a ``fleet`` it is ignored). ``probe`` (a
    :class:`~repro_torch.obs.probes.ProbeSpec`) turns on in-loop telemetry,
    surfaced as ``ExperimentResult.timeline``. ``reliability`` (a
    :class:`~repro_torch.reliability.ReliabilitySpec`) compiles per replica
    (seed + 1000 r) into the control stage's event timeline."""

    name: str
    platform: M.PlatformConfig = dataclasses.field(
        default_factory=M.PlatformConfig)
    horizon_s: float = 7 * 24 * 3600.0
    interarrival_factor: float = 1.0
    policy: int = des.POLICY_FIFO
    seed: int = 0
    n_replicas: int = 1
    engine: str = "torch"
    scenario: Optional[Scenario] = None
    workload: Optional[M.Workload] = None
    fleet: Optional[FleetSpec] = None
    trigger: Optional[TriggerSpec] = None
    probe: Optional[object] = None   # repro_torch.obs.probes.ProbeSpec
    reliability: Optional[object] = None   # reliability.ReliabilitySpec
    # a streamed workload (repro_torch.stream.TraceSource): the
    # "torch-stream" engine consumes it window by window, the others
    # materialize it into a pinned workload
    source: Optional[object] = None

    def with_(self, **kw) -> "ExperimentSpec":
        """Functional update (``dataclasses.replace`` with axis shorthands):
        plain field names, ``**{"capacity:<resource>": n}`` to resize one
        pool of the platform, ``**{"trigger:<field>": v}`` /
        ``**{"fleet:<field>": v}`` / ``**{"probe:<field>": v}`` /
        ``**{"reliability:<field>": v}`` to update one field of the
        lifecycle/telemetry/reliability specs (creating a default spec if
        there is none), or ``controller=<ReactiveController>`` to set the
        closed-loop controller on the spec's scenario (creating an
        otherwise-empty scenario if there is none). ``controller`` is
        applied after every other key, so combining it with a ``scenario``
        axis composes the same way regardless of kwarg order."""
        out = self
        ctrl = kw.pop("controller", _UNSET)
        for k, v in kw.items():
            if k.startswith("capacity:"):
                out = dataclasses.replace(
                    out, platform=out.platform.with_capacity(
                        k.split(":", 1)[1], v))
            elif k.startswith("trigger:"):
                trig = out.trigger if out.trigger is not None \
                    else TriggerSpec()
                out = dataclasses.replace(out, trigger=dataclasses.replace(
                    trig, **{k.split(":", 1)[1]: v}))
            elif k.startswith("fleet:"):
                fl = out.fleet if out.fleet is not None else FleetSpec()
                out = dataclasses.replace(out, fleet=dataclasses.replace(
                    fl, **{k.split(":", 1)[1]: v}))
            elif k.startswith("probe:"):
                from repro_torch.obs.probes import ProbeSpec
                pr = out.probe if out.probe is not None else ProbeSpec()
                out = dataclasses.replace(out, probe=dataclasses.replace(
                    pr, **{k.split(":", 1)[1]: v}))
            elif k.startswith("reliability:"):
                from repro_torch.reliability import ReliabilitySpec
                rl = out.reliability if out.reliability is not None \
                    else ReliabilitySpec()
                out = dataclasses.replace(
                    out, reliability=dataclasses.replace(
                        rl, **{k.split(":", 1)[1]: v}))
            else:
                out = dataclasses.replace(out, **{k: v})
        if ctrl is not _UNSET and not (ctrl is None and out.scenario is None):
            # (a None controller on a scenario-less spec stays pristine);
            # imported here: repro_torch.ops imports this package
            from repro_torch.ops.scenario import Scenario
            sc = out.scenario if out.scenario is not None \
                else Scenario(name="controller")
            out = dataclasses.replace(
                out, scenario=dataclasses.replace(sc, controller=ctrl))
        return out

    def to_spec(self) -> "ExperimentSpec":
        return self


def as_spec(exp) -> "ExperimentSpec":
    """Normalize anything exposing ``to_spec`` to an :class:`ExperimentSpec`."""
    return exp.to_spec()


@dataclasses.dataclass
class ExperimentResult:
    experiment: ExperimentSpec
    summary: Dict
    records: trace.TaskRecords
    wall_s: float
    replica_summaries: Optional[List[Dict]] = None
    # model-lifecycle view (runtime.LifecycleResult) of single-replica runs
    # of specs with a FleetSpec; ensembles aggregate lifecycle scalars into
    # the summary instead
    lifecycle: Optional[object] = None
    # in-loop telemetry view (obs.probes.ProbeTimeline) of single-replica
    # runs of specs with a ProbeSpec
    timeline: Optional[object] = None

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.records.save(os.path.join(directory, "records.npz"))
        exp = self.experiment
        if getattr(exp, "workload", None) is not None:
            exp = dataclasses.replace(exp, workload=None)  # tensors -> npz
        if getattr(exp, "source", None) is not None:
            exp = dataclasses.replace(
                exp, source=getattr(exp.source, "name", "source"))
        meta = {"experiment": dataclasses.asdict(exp),
                "summary": self.summary, "wall_s": self.wall_s}
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=_json_default)


def _json_default(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def run_experiment(exp, params: Optional[SimulationParams] = None,
                   device=None) -> ExperimentResult:
    """Run one experiment spec on its declared engine, on ``device``
    (``None``: the card)."""
    from repro_torch.core.engines import get_engine
    spec = as_spec(exp)
    res = get_engine(spec.engine, device).run(spec, params)
    res.experiment = exp            # hand back the caller's own object
    return res


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def _fmt_axis_value(v):
    return getattr(v, "name", v)    # scenarios print by name, not repr


@dataclasses.dataclass
class Sweep:
    """A Cartesian grid of experiments, run as ONE batched call.

    ``axes`` maps axis names to value lists. An axis name is a spec field
    (``interarrival_factor``, ``policy``, ``scenario``, ``seed``,
    ``platform``, ...), a shorthand of :meth:`ExperimentSpec.with_`
    (``"capacity:<resource name>"``, ``"trigger:<field>"``,
    ``"fleet:<field>"``, ``"probe:<field>"``, ``"reliability:<field>"``) or
    ``"controller"``, a list of
    :class:`~repro_torch.ops.capacity.ReactiveController` gains (or None).
    The whole grid (heterogeneous capacities, policies, scenarios,
    controllers, lifecycle and reliability policies and workloads, times
    ``n_replicas`` replicas each) executes as a single
    ``simulate_ensemble`` call; a ragged platform grid is padded with inert
    pools."""

    base: ExperimentSpec
    axes: Mapping[str, Sequence]

    def points(self) -> List[ExperimentSpec]:
        base = as_spec(self.base)
        names = list(self.axes)
        pts = []
        for combo in itertools.product(*[self.axes[k] for k in names]):
            spec = base.with_(**dict(zip(names, combo)))
            label = ",".join(f"{k.split(':', 1)[-1]}={_fmt_axis_value(v)}"
                             for k, v in zip(names, combo))
            pts.append(dataclasses.replace(
                spec, name=f"{base.name}/{label}" if label else base.name))
        return pts

    def run(self, params: Optional[SimulationParams] = None,
            device=None) -> List[ExperimentResult]:
        from repro_torch.core.engines import get_engine
        specs = self.points()
        # an "engine" axis dispatches each point on its own engine (each
        # still batches its own group); order is preserved
        results: List[Optional[ExperimentResult]] = [None] * len(specs)
        for name in dict.fromkeys(s.engine for s in specs):
            idx = [i for i, s in enumerate(specs) if s.engine == name]
            for i, r in zip(idx, get_engine(name, device).run_sweep(
                    [specs[i] for i in idx], params)):
                results[i] = r
        return results
