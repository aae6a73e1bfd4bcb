"""Representative workloads/specs + the capture shim for the dynamic passes
(mirrors :mod:`repro.analysis.harness`).

The trace and recompile audits don't invent call signatures — they record
the *production* ones. The engines look ``vdes.simulate_ensemble`` up as a
module attribute at call time, so :func:`capture_calls` swaps in a
recording shim, runs the real experiment path (``run_experiment`` /
``Sweep.run``), and hands the audit the exact ``(args, kwargs)`` the engine
produced. :meth:`CapturedCall.program` rebuilds the call's wave loop
(:func:`repro_torch.core.vdes.wave_program`), whose ``wave`` the audits
trace. The smoke spec exercises every wave stage at once (retry scenario +
closed-loop controller + fleet/trigger lifecycle + telemetry probe +
reliability) so a hazard in any stage is inside the traced wave.

Builders are deterministic (fixed seeds, integer times — the bit-parity
configuration) and small: the audits trace, they don't need statistics.
They are the reference's, on the port's ``"torch"`` / ``"torch-stream"``
engines.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import model as M
from repro_torch.core import vdes
from repro_torch.core.experiment import ExperimentSpec, Sweep
from repro_torch.core.metrics import FLEET_FIELDS
from repro_torch.core.runtime import FleetSpec, TriggerSpec

#: the arguments of ``simulate_ensemble`` that are not batch tensors: they
#: select the traced program itself (Python control flow and shapes)
STATIC_ARGNAMES = ("policy", "n_attempt_slots", "admission_sort",
                   "n_ctrl_slots", "n_probe_slots", "n_rel_slots",
                   "return_state", "sync_every", "device")
# simulate_ensemble's arguments that wave_program does not take
_LOOP_ONLY = ("return_state", "sync_every")


@dataclasses.dataclass
class CapturedCall:
    """One recorded engine call: positional args + kwargs, verbatim."""

    args: Tuple
    kwargs: Dict

    def split(self) -> Tuple[Dict, Dict]:
        """``(array_kwargs, static_kwargs)``."""
        static = {k: v for k, v in self.kwargs.items()
                  if k in STATIC_ARGNAMES}
        arrays = {k: v for k, v in self.kwargs.items()
                  if k not in STATIC_ARGNAMES}
        return arrays, static

    def arguments(self) -> Dict:
        """The call's arguments by name, but the loop's own
        (``return_state``, ``sync_every``): positional ones bound to
        ``vdes.wave_program``'s signature, which is ``simulate_ensemble``'s
        without those two."""
        kw = {k: v for k, v in self.kwargs.items() if k not in _LOOP_ONLY}
        sig = inspect.signature(vdes.wave_program)
        return dict(sig.bind(*self.args, **kw).arguments)

    def program(self, **overrides) -> "vdes.WaveProgram":
        """The call's wave loop, built by ``vdes.wave_program`` from the
        call's arguments (``overrides`` replace some, e.g.
        ``admission_sort``)."""
        return vdes.wave_program(**{**self.arguments(), **overrides})


def call_signature(call: "CapturedCall") -> Tuple:
    """The call's identity as a program: every static argument by value,
    every array argument by ``(shape, dtype)``. Two calls with equal
    signatures run the same wave program — the invariant the streaming
    driver's window loop is audited against (every ``resume``-carrying
    window call must produce ONE signature)."""
    def aval(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return ("arr", tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return ("seq", tuple(aval(v) for v in x))
        if isinstance(x, dict):
            return ("map", tuple((k, aval(x[k])) for k in sorted(x)))
        return ("static", repr(x))

    arrays, static = call.split()
    return (tuple(aval(a) for a in call.args),
            tuple((k, aval(arrays[k])) for k in sorted(arrays)),
            tuple(sorted((k, repr(v)) for k, v in static.items())))


@contextlib.contextmanager
def capture_calls(fn_name: str = "simulate_ensemble"):
    """Record every production call to ``vdes.<fn_name>`` while still
    executing it. Yields the (live) list of :class:`CapturedCall`."""
    calls: List[CapturedCall] = []
    orig = getattr(vdes, fn_name)

    def shim(*args, **kwargs):
        calls.append(CapturedCall(args, kwargs))
        return orig(*args, **kwargs)

    setattr(vdes, fn_name, shim)
    try:
        yield calls
    finally:
        setattr(vdes, fn_name, orig)


# ----------------------------------------------------------- smoke builders

def smoke_platform() -> M.PlatformConfig:
    return M.PlatformConfig(resources=(
        M.ResourceConfig("a", 3), M.ResourceConfig("b", 2)))


def smoke_workload(n: int = 40, horizon: float = 300.0,
                   seed: int = 20260807) -> M.Workload:
    """Small pinned integer-time workload (the bit-parity configuration)."""
    rng = np.random.default_rng(seed)
    max_tasks = 4
    arrival = np.floor(np.sort(rng.uniform(0, horizon, n)))
    n_tasks = rng.integers(1, max_tasks + 1, n)
    task_type = np.where(np.arange(max_tasks)[None, :] < n_tasks[:, None],
                         rng.integers(0, 2, (n, max_tasks)), -1)
    task_res = rng.integers(0, 2, (n, max_tasks))
    exec_time = np.ceil(rng.exponential(20.0, (n, max_tasks)))
    return M.Workload(
        arrival=arrival.astype(np.float64),
        n_tasks=n_tasks.astype(np.int32),
        task_type=task_type.astype(np.int32),
        task_res=(task_res * (task_type >= 0)).astype(np.int32),
        exec_time=exec_time * (task_type >= 0),
        read_bytes=np.zeros((n, max_tasks)),
        write_bytes=np.zeros((n, max_tasks)),
        framework=rng.integers(0, 5, n).astype(np.int32),
        priority=rng.uniform(0, 1, n).astype(np.float32),
        model_perf=np.zeros(n, np.float32),
        model_size=np.zeros(n, np.float32),
        model_clever=np.zeros(n, np.float32),
    )


def smoke_fleet_tensor(m: int = 3) -> np.ndarray:
    """Explicit drift rows with every process term live (gradual + jumps +
    seasonal) so the traced fleet stage contains the full arithmetic."""
    fl = np.zeros((m, FLEET_FIELDS), np.float32)
    fl[:, 0] = np.linspace(0.95, 0.8, m)     # perf0
    fl[:, 1] = np.linspace(2e-3, 3e-3, m)    # gradual rate
    fl[:, 2] = 0.01                          # jump rate
    fl[:, 3] = 0.05                          # jump scale
    fl[:, 4] = 0.02                          # seasonal amplitude
    fl[:, 5] = 200.0                         # seasonal period
    return fl


def smoke_controller():
    from repro_torch.ops.capacity import ReactiveController
    return ReactiveController(high_watermark=0.5, low_watermark=0.05,
                              step=0.25, interval_s=40.0, cooldown_s=40.0)


def smoke_scenario():
    from repro_torch.ops.scenario import Scenario
    return Scenario(name="analysis-smoke", controller=smoke_controller())


def smoke_probe():
    from repro_torch.obs.probes import ProbeSpec
    return ProbeSpec(interval_s=60.0)


def smoke_reliability():
    """A reliability spec dense enough to fire inside the 300 s smoke
    horizon: short domain MTBFs, one repair crew (so returns queue),
    a spot pool with mass evictions."""
    from repro_torch.reliability import (DomainOutageModel, ReliabilitySpec,
                                         RepairSpec, SpotPoolSpec,
                                         TopologySpec)
    return ReliabilitySpec(
        topology=TopologySpec(zones=2, racks_per_zone=2),
        outages=DomainOutageModel(zone_mtbf_s=120.0, rack_mtbf_s=80.0,
                                  mttr_s=30.0),
        repair=RepairSpec(crews=1, repair_time_s=30.0),
        spot=SpotPoolSpec(frac=0.4, evict_mtbe_s=150.0, reclaim_s=20.0),
        time_quantum_s=1.0)   # integer event grid: the bit-parity config


def smoke_spec(engine: str = "torch") -> ExperimentSpec:
    """One spec that lights up every wave stage: completion/admission
    (always), control (ReactiveController), fleet (FleetSpec + TriggerSpec),
    probe (ProbeSpec), reliability (ReliabilitySpec)."""
    return ExperimentSpec(
        name="analysis-smoke",
        platform=smoke_platform(),
        horizon_s=300.0,
        workload=smoke_workload(),
        engine=engine,
        scenario=smoke_scenario(),
        fleet=FleetSpec(params=smoke_fleet_tensor()),
        trigger=TriggerSpec(drift_threshold=0.05, cooldown_s=60.0,
                            obs_noise=0.01, interval_s=20.0,
                            retrain_durations=(40.0, 5.0, 15.0)),
        probe=smoke_probe(),
        reliability=smoke_reliability(),
    )


def smoke_stream_source(block: int = 12):
    """:func:`smoke_workload` served as a :class:`~repro_torch.stream.
    TraceSource` (fixed-size arrival-ordered blocks) — the streamed
    counterpart of the pinned smoke workload, for auditing the windowed
    driver's call signatures."""
    wl = smoke_workload()

    class _Source:
        name = "smoke-stream"

        def blocks(self):
            n = wl.arrival.shape[0]
            for lo in range(0, n, block):
                hi = min(lo + block, n)
                yield M.Workload(**{
                    f.name: (v[lo:hi] if isinstance(
                        v := getattr(wl, f.name), np.ndarray) else v)
                    for f in dataclasses.fields(M.Workload)})

    return _Source()


def smoke_stream_spec() -> ExperimentSpec:
    """The full-stack smoke spec in streamed form (``"torch-stream"`` over
    a :func:`smoke_stream_source`): same scenario/fleet/trigger/probe
    stack, consumed windowwise."""
    return dataclasses.replace(smoke_spec(engine="torch-stream"),
                               workload=None, source=smoke_stream_source(),
                               reliability=None)  # stream engine rejects it


def smoke_sweep() -> Sweep:
    """The representative mixed grid the recompile audit runs: capacity x
    controller x trigger x probe x reliability axes (2*2*2*2*2 = 32
    points). Every axis value must land in the batch tensors — none may
    split the grid into several calls or wave programs (reliability
    points with and without events share the batch via never-firing
    padding rows)."""
    base = smoke_spec(engine="torch")
    return Sweep(base, {
        "capacity:a": [3, 4],
        "controller": [None, smoke_controller()],
        "trigger:drift_threshold": [0.05, 0.2],
        "probe:interval_s": [60.0, 100.0],
        "reliability": [None, smoke_reliability()],
    })
