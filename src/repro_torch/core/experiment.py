"""Declarative experiment API (mirrors :mod:`repro.core.experiment`; paper
§IV: "The main entry point for users is to define an experiment and its
parameters, systematically mutating them in an iterative, exploratory
process").

:class:`ExperimentSpec` is inert data: a full
:class:`~repro_torch.core.model.PlatformConfig`, workload parameters, an
admission policy, an operational
:class:`~repro_torch.ops.scenario.Scenario`, and replication/seed control.
It keeps the reference's fields; the ones whose engine stages are not
ported yet (``fleet``, ``trigger``, ``probe``, ``reliability``,
``source``) stay on the spec and are refused by the engine
(:func:`repro_torch.core.engines.check_ported`). ``engine`` names the one
engine the port has, ``"torch"``.

:class:`Sweep` composes a spec with named axes (spec fields,
``"capacity:<resource>"`` shorthands, scenarios, policies, seeds) into a
Cartesian grid that runs as ONE batched ``simulate_ensemble`` call.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import des, trace
from repro_torch.core import model as M
from repro_torch.core.fitting import SimulationParams
from repro_torch.ops.scenario import Scenario

# with_() prefixes of the reference whose stages are not ported yet
_UNPORTED_AXES = ("trigger:", "fleet:", "probe:", "reliability:")


@dataclasses.dataclass
class ExperimentSpec:
    """A declarative experiment over an arbitrary platform. ``workload``
    optionally pins a pre-materialized :class:`~repro_torch.core.model.
    Workload` (then no synthesis happens and ``interarrival_factor`` is
    ignored) — the hook parity tests and trace replays use."""

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
    # not ported yet: the engine refuses a spec that sets any of these
    fleet: Optional[object] = None
    trigger: Optional[object] = None
    probe: Optional[object] = None
    reliability: Optional[object] = None
    source: Optional[object] = None

    def with_(self, **kw) -> "ExperimentSpec":
        """Functional update: plain field names, or
        ``**{"capacity:<resource>": n}`` to resize one pool of the
        platform. The reference's ``trigger:``/``fleet:``/``probe:``/
        ``reliability:`` shorthands and ``controller`` raise: their stages
        are not ported yet."""
        out = self
        for k, v in kw.items():
            if k.startswith("capacity:"):
                out = dataclasses.replace(
                    out, platform=out.platform.with_capacity(
                        k.split(":", 1)[1], v))
            elif k == "controller" or k.startswith(_UNPORTED_AXES):
                raise NotImplementedError(
                    f"with_({k}=...): that engine stage is not ported to "
                    "repro_torch yet")
            else:
                out = dataclasses.replace(out, **{k: v})
        return out

    def to_spec(self) -> "ExperimentSpec":
        return self


@dataclasses.dataclass
class ExperimentResult:
    experiment: ExperimentSpec
    summary: Dict
    records: trace.TaskRecords
    wall_s: float
    replica_summaries: Optional[List[Dict]] = None

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.records.save(os.path.join(directory, "records.npz"))
        exp = self.experiment
        if getattr(exp, "workload", None) is not None:
            exp = dataclasses.replace(exp, workload=None)  # tensors -> npz
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
    """Run one experiment spec on ``device`` (``None``: the card)."""
    from repro_torch.core.engines import TorchEngine
    res = TorchEngine(device).run(exp.to_spec(), params)
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
    ``platform``, ...) or the shorthand ``"capacity:<resource name>"``.
    The whole grid (heterogeneous capacities, policies, scenarios and
    workloads, times ``n_replicas`` replicas each) executes as a single
    ``simulate_ensemble`` call; a ragged platform grid is padded with inert
    pools."""

    base: ExperimentSpec
    axes: Mapping[str, Sequence]

    def points(self) -> List[ExperimentSpec]:
        base = self.base.to_spec()
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
        from repro_torch.core.engines import TorchEngine
        return TorchEngine(device).run_sweep(self.points(), params)
