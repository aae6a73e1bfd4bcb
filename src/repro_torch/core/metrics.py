"""Fleet drift algebra of the run-time view, Fig 7 (mirrors the fleet half
of :mod:`repro.core.metrics`; the model-compression metrics are not ported).

A *fleet* of M deployed models is one ``[..., M, FLEET_FIELDS]`` tensor
(columns below). The drift evaluation — performance at time t given the
per-model drift processes, the accumulated sudden-drift losses and the time
since the last (re)deployment — is a handful of elementwise ops shared by
the engine's fleet stage (f32 torch, batched over replicas) and the f64
scalar :class:`DeployedModel` view. ``xp`` selects the namespace
(``numpy`` or ``torch``); arithmetic stays in the input dtype, and the
operation ORDER is part of the contract: the engine must agree with the
reference's numpy mirror bit for bit in f32 (with ``seasonal_amp == 0``
the ``cos`` term is multiplied away, so parity is exact).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.numerics import fma_free_msub, guarded_denominator

(FLEET_PERF0, FLEET_GRAD_RATE, FLEET_JUMP_RATE, FLEET_JUMP_SCALE,
 FLEET_SEAS_AMP, FLEET_SEAS_PERIOD) = range(6)
FLEET_FIELDS = 6


def fleet_performance(perf0, jump_acc, dt, fleet, xp=np):
    """[M] performance ``dt`` seconds after each model's deployment: the
    continuous closed form (gradual drift ``rate * dt``). It backs the
    scalar :class:`DeployedModel` view; the engine uses
    :func:`fleet_performance_acc` instead."""
    grad = fleet[..., FLEET_GRAD_RATE]
    amp = fleet[..., FLEET_SEAS_AMP]
    period = fleet[..., FLEET_SEAS_PERIOD]
    season = amp * 0.5 * (1.0 - xp.cos(2.0 * np.pi * dt / period))
    return xp.clip(perf0 - grad * dt - jump_acc - season, 0.0, 1.0)


def fleet_performance_acc(perf0, drift_acc, dt, fleet, xp=np):
    """[M] performance from the *accumulated-loss* formulation the engines
    execute: ``drift_acc`` is the running sum of presampled per-tick drift
    increments since the model's last (re)deployment. Every runtime op is
    add/sub/clip on rounded f32 values; the seasonal term goes through
    :func:`fma_free_msub` and vanishes exactly when ``seasonal_amp == 0``.
    The seasonal period runs through :func:`guarded_denominator`, so
    all-zero padding rows never divide by zero."""
    return performance_from_terms(perf0, drift_acc, dt,
                                  *seasonal_terms(fleet, xp=xp), xp=xp)


def seasonal_terms(fleet, xp=np):
    """The drift processes' time-invariant seasonal factors of
    :func:`fleet_performance_acc`: ``(amp * 0.5, guarded period)``. The
    engine computes them once per run instead of once per wave."""
    amp = fleet[..., FLEET_SEAS_AMP]
    period = guarded_denominator(fleet[..., FLEET_SEAS_PERIOD], xp=xp)
    return amp * 0.5, period


def performance_from_terms(perf0, drift_acc, dt, amp_half, period, xp=np):
    """:func:`fleet_performance_acc` given :func:`seasonal_terms`."""
    season_arg = 1.0 - xp.cos(2.0 * np.pi * dt / period)
    return xp.clip(
        fma_free_msub(perf0 - drift_acc, amp_half, season_arg, xp=xp),
        0.0, 1.0)


def fleet_staleness(perf0, perf, xp=np):
    """[M] staleness in [0, 1]: performance decrease relative to the freshly
    deployed model (§III-A)."""
    return xp.clip(perf0 - perf, 0.0, 1.0)


def pack_fleet(models) -> np.ndarray:
    """Pack :class:`DeployedModel` instances into the ``[M, FLEET_FIELDS]``
    f32 fleet tensor the engine consumes."""
    out = np.zeros((len(models), FLEET_FIELDS), np.float32)
    for i, m in enumerate(models):
        out[i] = (m.perf0, m.gradual_rate, m.jump_rate, m.jump_scale,
                  m.seasonal_amp, m.seasonal_period)
    return out


@dataclasses.dataclass
class DeployedModel:
    """Run-time view of one deployed model (Fig 7): a scalar f64 wrapper
    over the fleet drift algebra above."""

    model_id: int
    perf0: float                 # performance right after (re)training
    deployed_at: float           # seconds
    gradual_rate: float          # perf loss per second (concept drift, slow)
    jump_rate: float             # sudden-drift events per second
    jump_scale: float            # mean magnitude of sudden drops
    seasonal_amp: float = 0.0    # recurring-drift amplitude (Fig 2 bottom)
    seasonal_period: float = 7 * 24 * 3600.0
    last_jumps: float = 0.0      # accumulated sudden losses

    def _row(self) -> np.ndarray:
        return np.array([[self.perf0, self.gradual_rate, self.jump_rate,
                          self.jump_scale, self.seasonal_amp,
                          self.seasonal_period]], np.float64)

    def performance(self, t: float) -> float:
        dt = max(t - self.deployed_at, 0.0)
        return float(fleet_performance(
            np.float64(self.perf0), np.float64(self.last_jumps),
            np.float64(dt), self._row())[0])

    def staleness(self, t: float) -> float:
        """Staleness in [0, 1] relative to the freshly deployed model."""
        return float(fleet_staleness(np.float64(self.perf0),
                                     self.performance(t)))

    def potential_improvement(self, t: float, new_data_fraction: float) -> float:
        """§III-A: potential ~ f(current performance p(M), newly labeled data
        since last retraining)."""
        p = self.performance(t)
        return float(np.clip((1.0 - p) * 0.6 + self.staleness(t) * 0.3
                             + new_data_fraction * 0.1, 0.0, 1.0))
