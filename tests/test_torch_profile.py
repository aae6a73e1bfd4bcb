"""The port's self-profiler (``obs/profile.py``) against the JAX package's,
on the CPU.

A whole-second workload with a closed-loop controller, a fleet of drifting
models with a trigger and an in-loop probe, built by both packages' host
sides from the same draws. ``profile_compile_execute`` and
``stage_attribution`` must return the reference's keys, and their wave
counts must equal the reference engine's exactly. The reference's fleet
stage fails on this tree (``core/numerics.py``'s barrier under JAX 0.9),
so the fleet's waves are held against ``des.simulate`` instead. Times are
only checked to be positive and finite.
"""
import math

import numpy as np
import pytest
import torch

import torch_stage_cases as C
from repro.core import des as ref_des
from repro.core import runtime as ref_rt
from repro.obs import probes as ref_probes
from repro.obs import profile as ref_profile
from repro.ops import capacity as ref_cap
from repro.ops import scenario as ref_scen
from repro_torch.core import runtime
from repro_torch.obs import probes, profile
from repro_torch.ops import capacity, scenario

STAGES = ("select+completion+admission", "control", "fleet", "probe")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Each package's (extended workload, platform, controller scenario,
    fleet, probe), from one whole-second workload."""
    H = C.HORIZON
    wl = C.workloads(41, sizes=(C.N,))[0]
    fl = np.array([[0.9, 2e-3, 0.0, 0.05, 0.0, 86400.0],
                   [0.8, 1e-3, 0.0, 0.05, 0.0, 86400.0]], np.float32)
    out = []
    for rt, scen, cap, prb, w, plat in (
            (ref_rt, ref_scen, ref_cap, ref_probes, wl, C.platforms()[0]),
            (runtime, scenario, capacity, probes, C.port_workload(wl),
             C.platforms()[1])):
        cf, ext = scen.compile_fleet(
            rt.FleetSpec(params=fl),
            rt.TriggerSpec(drift_threshold=0.05, cooldown_s=60.0,
                           obs_noise=0.0, interval_s=60.0,
                           retrain_durations=(40.0, 10.0, 20.0)),
            w, plat, H, seed=3)
        comp = scen.Scenario(name="ctrl", controller=cap.ReactiveController(
            high_watermark=0.3, low_watermark=0.05, step=0.5,
            min_scale=0.5, max_scale=3.0, interval_s=120.0)).compile(
            ext, plat, H, seed=3)
        probe = prb.compile_probe(prb.ProbeSpec(interval_s=90.0), H,
                                  n_models=cf.n_models)
        out.append((ext, plat, comp, cf, probe))
    return out


def _finite_positive(d, keys):
    for k in keys:
        assert math.isfinite(d[k]) and d[k] >= 0, (k, d[k])


def test_profile_compile_execute_equals_reference(case):
    (rext, rplat, rcomp, _, rprobe), (ext, plat, comp, _, probe) = case
    want = ref_profile.profile_compile_execute(rext, rplat, scenario=rcomp,
                                               probe=rprobe, repeats=1)
    got = profile.profile_compile_execute(ext, plat, scenario=comp,
                                          probe=probe, repeats=2,
                                          device="cpu")
    assert list(got) == list(want)
    assert got["waves"] == want["waves"] > 0
    _finite_positive(got, got)
    assert got["execute_s"] > 0
    assert got["waves_per_s"] == pytest.approx(
        got["waves"] / got["execute_s"])


def test_stage_attribution_equals_reference(case):
    """Base, control and probe against the reference's ablation (its keys
    and waves); the fleet's waves against ``des.simulate``."""
    (rext, rplat, rcomp, rcf, rprobe), (ext, plat, comp, cf, probe) = case
    want = ref_profile.stage_attribution(rext, rplat, scenario=rcomp,
                                         probe=rprobe, repeats=1)
    got = profile.stage_attribution(ext, plat, scenario=comp, fleet=cf,
                                    probe=probe, repeats=1, device="cpu")
    assert list(got) == list(STAGES)
    for name in want:
        assert list(got[name]) == list(want[name])
        assert got[name]["waves"] == want[name]["waves"], name
        _finite_positive(got[name], got[name])
    fleet_waves = ref_des.simulate(rext, rplat, fleet=rcf).waves
    assert got["fleet"]["waves"] == fleet_waves
    assert got["select+completion+admission"]["wall_s"] > 0


def test_stage_attribution_omits_stages_not_supplied(case):
    ext, plat, comp = case[1][:3]
    got = profile.stage_attribution(ext, plat, scenario=comp, repeats=1,
                                    device="cpu")
    assert list(got) == ["select+completion+admission", "control"]
