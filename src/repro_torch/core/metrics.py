"""ML model metrics (paper §III-A, §V-A.2d Table I; mirrors
:mod:`repro.core.metrics`): the Table I compression-effect model and the
fleet drift algebra of the run-time view, Fig 7.

The paper publishes measured pruning effects for GoogleNet / ResNet50 on
Food101 and notes "the relative changes in model metrics could be described
by a regression model": :func:`compression_effect` interpolates Table I
exactly at its knots or fits that quadratic regression, and
:func:`apply_compression` mutates model assets with it in compress tasks.

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
from typing import Literal

import numpy as np

from repro_torch.core.numerics import fma_free_msub, guarded_denominator

# Table I (prune %, accuracy %, size MB, inference ms)
PRUNE_LEVELS = np.array([0.0, 0.2, 0.4, 0.6, 0.8])
TABLE1 = {
    "googlenet": {
        "accuracy": np.array([80.7, 80.9, 80.0, 77.7, 69.8]),
        "size_mb": np.array([42.5, 28.7, 20.9, 14.6, 8.5]),
        "inference_ms": np.array([128.0, 117.0, 100.0, 84.0, 71.0]),
    },
    "resnet50": {
        "accuracy": np.array([81.3, 80.9, 80.8, 79.5, 69.8]),
        "size_mb": np.array([91.1, 83.5, 65.2, 41.9, 8.5]),
        "inference_ms": np.array([223.0, 200.0, 169.0, 141.0, 72.0]),
    },
}


def compression_effect(prune: np.ndarray, arch: str = "resnet50",
                       metric: str = "accuracy",
                       mode: Literal["interp", "poly"] = "interp") -> np.ndarray:
    """Relative multiplier on a model metric after pruning ``prune`` in [0,1].

    ``interp`` reproduces Table I exactly at the knots; ``poly`` is the
    quadratic regression the paper suggests.
    """
    tab = TABLE1[arch][metric]
    rel = tab / tab[0]
    prune = np.asarray(prune, np.float64)
    if mode == "interp":
        return np.interp(prune, PRUNE_LEVELS, rel)
    coef = np.polyfit(PRUNE_LEVELS, rel, 2)
    return np.polyval(coef, np.clip(prune, 0.0, 0.8))


def apply_compression(perf: np.ndarray, size: np.ndarray, prune: np.ndarray,
                      arch: str = "resnet50",
                      rng: np.random.Generator | None = None):
    """Mutate (performance, size) of model assets for a compress task; the
    Gaussian jitter mirrors §V-A.2d. ``rng`` defaults to
    ``np.random.default_rng(0)``, as in the reference, so the draws are
    the reference's."""
    rng = rng or np.random.default_rng(0)
    f_acc = compression_effect(prune, arch, "accuracy")
    f_sz = compression_effect(prune, arch, "size_mb")
    jitter = rng.normal(1.0, 0.01, np.shape(prune))
    return np.clip(perf * f_acc * jitter, 0.0, 1.0), size * f_sz


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
        # [0] picks the single result row, not a layout
        # field.  # parity: allow(layout-index)
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
