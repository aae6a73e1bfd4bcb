"""The step-time watchdog of :mod:`repro.checkpoint.manager`.

Only :class:`StragglerMonitor` is ported: the reliability compiler
(:mod:`repro_torch.reliability.compile`) streams repair-crew service times
through it. The reference's checkpoint manager and fault injector serve its
training launcher, which the port does not have.
"""
from __future__ import annotations

from typing import List

import numpy as np


class StragglerMonitor:
    """Step-time watchdog: flags steps slower than ``threshold x`` the
    trailing median. Also the simulator's repair watchdog:
    :func:`repro_torch.reliability.compile_reliability` streams repair-crew
    service durations through one of these, so pathologically slow repairs
    surface in ``availability_summary`` (``n_stragglers``)."""

    def __init__(self, window: int = 20, threshold: float = 2.5):
        self.times: List[float] = []
        self.window = window
        self.threshold = threshold
        self.flagged: List[int] = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if seconds > self.threshold * med:
                self.flagged.append(step)
                return True
        return False
