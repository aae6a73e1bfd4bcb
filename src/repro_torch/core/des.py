"""Constants the PyTorch port shares with the reference engines.

The numpy heap engine of :mod:`repro.core.des` is not ported: it is the
oracle, and the port's tests run the reference's own. What the port's
engine and host side need of that module are its admission-policy codes and
its f32 "never" sentinel, copied here, and ``single_station_fifo``, the f64
oracle of the ``queue_scan`` kernel, which ``chip_smoke.py`` runs on the
card's machine where the reference is not installed.
"""
from __future__ import annotations

import numpy as np

POLICY_FIFO, POLICY_PRIORITY, POLICY_SJF = 0, 1, 2
POLICY_NAMES = ["fifo", "priority", "sjf"]

# THE f32 "never" sentinel, shared bit-for-bit with the reference engines.
# Finite in f32 on purpose (float("inf") would poison min reductions).
CTRL_INF = np.float32(3.0e38)


def single_station_fifo(ready: np.ndarray, service: np.ndarray,
                        capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact c-server FIFO queue for ONE resource, slots in f64: the oracle
    of the ``queue_scan`` kernel (a copy of
    :func:`repro.core.des.single_station_fifo`). Returns (start, finish)."""
    order = np.argsort(ready, kind="stable")
    slots = np.zeros(capacity)
    start = np.empty_like(ready)
    finish = np.empty_like(ready)
    for j in order:
        k = int(np.argmin(slots))
        s = max(ready[j], slots[k])
        start[j] = s
        finish[j] = s + service[j]
        slots[k] = finish[j]
    return start, finish
