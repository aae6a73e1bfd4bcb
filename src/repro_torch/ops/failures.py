"""Failure & retry injection (AIReSim-style reliability modeling).

Numpy-only copy of :mod:`repro.ops.failures` for the PyTorch port. Two
failure channels, both pre-sampled on the host into plain tensors, so the
batched wave loop on the device draws no random numbers:

  - **task failures**: each service attempt of a task fails independently with
    a probability determined by its task type (and a per-framework
    multiplier). A failed attempt occupies the resource for the full service
    time, then re-queues after a bounded exponential backoff. The sampled
    ``attempts[N, T]`` tensor (truncated geometric: the run after
    ``max_retries`` failures completes) is all the engines need — backoff
    delays are deterministic, so numpy f64 and JAX f32 agree exactly on
    integer-time workloads.

  - **node outages**: a Poisson process per resource pool takes down a
    fraction of nodes for an exponential repair time; outages compose onto
    the capacity schedule as negative deltas (:func:`repro_torch.ops.
    capacity.apply_capacity_deltas`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import model as M


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: the k-th retry (k = 0, 1, ...) waits
    ``min(base_s * mult**k, cap_s)`` after the failed attempt finishes."""

    max_retries: int = 3
    base_s: float = 30.0
    mult: float = 2.0
    cap_s: float = 1800.0

    def delay(self, k: int) -> float:
        return float(min(self.base_s * self.mult ** k, self.cap_s))

    @property
    def backoff(self) -> Tuple[float, float, float]:
        """(base, mult, cap) triple the engines consume."""
        return (float(self.base_s), float(self.mult), float(self.cap_s))


# Default per-task-type failure probabilities: long-running
# training/compression jobs fail more often than short preprocess/deploy ops.
DEFAULT_P_FAIL = (0.01, 0.05, 0.02, 0.04, 0.04, 0.01)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Per-attempt failure probabilities by task type, modulated per framework.

    ``resample_service=True`` draws a fresh service time for every *retry*
    attempt (attempt 0 keeps the synthesized duration, so the flag is a
    strict extension: with no failures, behavior is identical to the flag
    being off — the parity-test escape hatch the seed behavior relied on).
    Retries are modeled as i.i.d. mean-preserving lognormal multiples of the
    base service time (``exp(sigma*z - sigma^2/2)``), since the synthesizer's
    per-task duration distribution is no longer available once the workload
    is materialized.

    ``fail_holds_frac < 1.0`` models *partial-progress* failures: a failing
    attempt holds its resource slot for only that fraction of its service
    time before crashing (the default 1.0 — fail at the very end — preserves
    the historical trace semantics exactly). Both engines shorten the
    attempt's recorded start/finish window accordingly, so per-attempt
    ``busy_node_seconds`` accounting stays exact.
    """

    p_fail_by_type: Tuple[float, ...] = DEFAULT_P_FAIL
    framework_mult: Tuple[float, ...] = (1.0,) * M.N_FRAMEWORKS
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    resample_service: bool = False
    resample_sigma: float = 0.35
    fail_holds_frac: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.fail_holds_frac <= 1.0:
            raise ValueError(
                f"fail_holds_frac must be in (0, 1], got "
                f"{self.fail_holds_frac} (a non-positive hold would emit "
                "finish events in the past)")

    def failure_prob(self, wl: M.Workload) -> np.ndarray:
        """[N, T] per-attempt failure probability (0 on padding)."""
        p_type = np.asarray(self.p_fail_by_type, np.float64)
        f_mult = np.asarray(self.framework_mult, np.float64)
        p = p_type[np.clip(wl.task_type, 0, M.N_TASK_TYPES - 1)]
        p = p * f_mult[np.clip(wl.framework, 0, M.N_FRAMEWORKS - 1)][:, None]
        return np.clip(p, 0.0, 0.95) * (wl.task_type >= 0)

    def sample_attempts(self, rng: np.random.Generator,
                        wl: M.Workload) -> np.ndarray:
        """[N, T] i64 number of service attempts per task (>= 1).

        Truncated geometric: P(attempts = 1 + k) = (1 - p) p^k for
        k < max_retries, with the tail mass collapsed onto
        ``1 + max_retries`` (the post-final-retry run always completes, so a
        scenario cannot deadlock the pipeline DAG).
        """
        p = self.failure_prob(wl)
        u = rng.random(p.shape)
        with np.errstate(divide="ignore", invalid="ignore"):
            fails = np.where(p > 0.0,
                             np.floor(np.log(np.maximum(u, 1e-300))
                                      / np.log(np.where(p > 0, p, 0.5))),
                             0.0)
        fails = np.clip(fails, 0, self.retry.max_retries).astype(np.int64)
        return 1 + fails

    def sample_attempt_services(self, rng: np.random.Generator,
                                service: np.ndarray) -> np.ndarray:
        """[N, T, A] per-attempt service times (A = max_retries + 1).

        Slot 0 is the base service time unchanged; slots k >= 1 are
        independent mean-preserving lognormal resamples. Engines index
        attempt k at ``min(k, A-1)``, so the tensor covers every attempt the
        truncated-geometric ``sample_attempts`` can request.
        """
        s = np.asarray(service, np.float64)
        n_slots = self.retry.max_retries + 1
        out = np.repeat(s[..., None], n_slots, axis=-1)
        if n_slots > 1 and self.resample_sigma > 0:
            z = rng.standard_normal(s.shape + (n_slots - 1,))
            out[..., 1:] = s[..., None] * np.exp(
                self.resample_sigma * z - 0.5 * self.resample_sigma ** 2)
        return out


@dataclasses.dataclass(frozen=True)
class OutageModel:
    """Node outages per resource pool: a Poisson process with mean time
    between failures ``mtbf_s`` takes down ``frac_lost`` of the pool for an
    Exp(``mttr_s``) repair time."""

    mtbf_s: float = 7 * 86400.0
    mttr_s: float = 2 * 3600.0
    frac_lost: float = 0.25
    resources: Optional[Tuple[int, ...]] = None   # None = every pool

    def sample_outages(self, rng: np.random.Generator, horizon_s: float,
                       base_caps: np.ndarray
                       ) -> List[Tuple[float, float, int, int]]:
        """Capacity deltas ``(t0, t1, resource, -nodes_lost)``."""
        base_caps = np.asarray(base_caps, np.int64)
        which = range(base_caps.shape[0]) if self.resources is None \
            else self.resources
        deltas: List[Tuple[float, float, int, int]] = []
        for r in which:
            lost = int(round(base_caps[int(r)] * self.frac_lost))
            if lost <= 0:
                continue
            t = float(rng.exponential(self.mtbf_s))
            while t < horizon_s:
                dur = float(rng.exponential(self.mttr_s))
                deltas.append((t, min(t + dur, horizon_s), int(r), -lost))
                t += dur + float(rng.exponential(self.mtbf_s))
        return deltas
