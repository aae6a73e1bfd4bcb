"""Constants the PyTorch port shares with the reference engines.

The numpy heap engine of :mod:`repro.core.des` is not ported: it is the
oracle, and the port's tests run the reference's own. What the port's
engine and host side need of that module are its admission-policy codes and
its f32 "never" sentinel, copied here.
"""
from __future__ import annotations

import numpy as np

POLICY_FIFO, POLICY_PRIORITY, POLICY_SJF = 0, 1, 2
POLICY_NAMES = ["fifo", "priority", "sjf"]

# THE f32 "never" sentinel, shared bit-for-bit with the reference engines.
# Finite in f32 on purpose (float("inf") would poison min reductions).
CTRL_INF = np.float32(3.0e38)
