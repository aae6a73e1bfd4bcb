"""Self-profiler: where does the *simulator's* wall time go? (mirrors
:mod:`repro.obs.profile`, on the port's engines).

  - :func:`profile_compile_execute`: the batched engine's cold-vs-warm
    wall split (the cold first call includes the kernels' load and build
    and the allocator's warm-up; warm calls run only), plus executed waves
    and **waves/s**;
  - :func:`profile_numpy`: the heap engine's wall and waves/s on the same
    program, on the host (the serial baseline every batched speedup is
    quoted against);
  - :func:`stage_attribution`: per-stage cost attribution across the wave
    loop's stages by *differential ablation*: the same workload runs with
    the optional stages toggled (base = select + completion + admission;
    then + control, + fleet, + probe), and each stage's per-wave cost is
    the delta over its baseline.

All timings take the best of ``repeats`` (the minimum, the standard
noise-floor estimator). On the card the host clock is read after a
``torch.cuda.synchronize()``, so a call's wall holds its device work. The
reference clears JAX's compilation caches first so that its cold call
recompiles; PyTorch has no counterpart (a loaded kernel library stays
loaded), so ``cold_s`` counts the build and load only in a process that
has not run the engine yet, and ``compile_s`` is otherwise the allocator's
and the first dispatch's warm-up.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.core import des, vdes
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(fn, repeats: int, dev: torch.device) -> float:
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_numpy(wl, platform, policy: int = des.POLICY_FIFO,
                  scenario=None, fleet=None, probe=None,
                  repeats: int = 3) -> Dict[str, float]:
    """Wall + waves/s of the heap engine (:func:`repro_torch.core.des.
    simulate`, on the host) on one program."""
    tr = des.simulate(wl, platform, policy, scenario=scenario, fleet=fleet,
                      probe=probe)
    wall = _best_of(lambda: des.simulate(wl, platform, policy,
                                         scenario=scenario, fleet=fleet,
                                         probe=probe),
                    repeats, torch.device("cpu"))
    return {"wall_s": wall, "waves": int(tr.waves),
            "waves_per_s": tr.waves / max(wall, 1e-12)}


def profile_compile_execute(wl, platform, policy: int = des.POLICY_FIFO,
                            scenario=None, fleet=None, probe=None,
                            repeats: int = 3,
                            device=None) -> Dict[str, float]:
    """The engine's cold/warm split on one program, on ``device``
    (``None``: the card).

    ``compile_s`` is the cold-call overhead (first call minus the best
    warm call), clipped at 0."""
    dev = resolve_device(device)

    def run():
        return vdes.simulate_to_trace(wl, platform, policy,
                                      scenario=scenario, fleet=fleet,
                                      probe=probe, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    tr = run()
    _sync(dev)
    cold = time.perf_counter() - t0
    execute = _best_of(run, repeats, dev)
    return {"cold_s": cold, "execute_s": execute,
            "compile_s": max(cold - execute, 0.0),
            "waves": int(tr.waves),
            "waves_per_s": tr.waves / max(execute, 1e-12)}


def stage_attribution(wl, platform, scenario=None, fleet=None, probe=None,
                      policy: int = des.POLICY_FIFO, repeats: int = 3,
                      device=None) -> Dict[str, Dict[str, float]]:
    """Per-stage wall attribution by differential ablation, on ``device``
    (``None``: the card).

    Returns ``{stage: {per_wave_us, waves, wall_s}}`` for the always-on
    core (``select+completion+admission``, the base config's whole wave)
    and a delta entry per optional stage that was supplied (``control`` /
    ``fleet`` / ``probe``: that stage's config minus the base, per wave;
    clipped at 0 when the delta drowns in noise). Stages the caller didn't
    supply (no scenario/fleet/probe) are omitted, not estimated."""
    configs = {"base": {}}
    if scenario is not None:
        configs["control"] = {"scenario": scenario}
    if fleet is not None:
        configs["fleet"] = {"fleet": fleet}
    if probe is not None:
        configs["probe"] = {"probe": probe}

    measured = {}
    for name, kw in configs.items():
        prof = profile_compile_execute(wl, platform, policy, repeats=repeats,
                                       device=device, **kw)
        measured[name] = {"wall_s": prof["execute_s"],
                          "waves": prof["waves"],
                          "per_wave_us": 1e6 * prof["execute_s"]
                          / max(prof["waves"], 1)}
    base_pw = measured["base"]["per_wave_us"]
    out = {"select+completion+admission": {
        "per_wave_us": base_pw,
        "waves": measured["base"]["waves"],
        "wall_s": measured["base"]["wall_s"],
    }}
    for name in ("control", "fleet", "probe"):
        if name not in measured:
            continue
        m = measured[name]
        out[name] = {"per_wave_us": max(m["per_wave_us"] - base_pw, 0.0),
                     "waves": m["waves"], "wall_s": m["wall_s"]}
    return out
