"""Checkpointing with atomic writes, keep-last-k and async save, the fault
injector and the step-time watchdog (mirrors
:mod:`repro.checkpoint.manager`).

Format: one ``.npz`` per step, ``ckpt_{step:08d}.npz``, leaves keyed by
their path in the state tree joined with ``/`` (a tree is nested dicts of
tensors, as the port's parameter and optimizer trees are). numpy has no
bf16, and a round through f32 is no checkpoint: a bf16 leaf is stored as
its uint16 bits, and the entry ``__dtypes__`` (a JSON object, name ->
torch dtype) records every leaf's dtype, so a restore is bit for bit.
Leaves are copied to the host on save and placed on the target's device
on restore, so a checkpoint written on the card restores onto the CPU and
back.

The training loop in :mod:`repro_torch.launch.train` wraps this with
crash-restart: failures (injected ones included) roll back to the latest
checkpoint, and the deterministic data pipeline replays from the restored
step.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import tree_items

_DTYPES_KEY = "__dtypes__"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates cannot reach; bf16
    as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    # ------------------------------------------------------------- save
    def save(self, step: int, state_tree, block: bool = False) -> str:
        """Copies every leaf to the host now (so the caller may go on
        updating the tree), then writes ``.tmp`` and renames it into place
        on a thread, or here with ``block``; the oldest checkpoints beyond
        ``keep_last`` are removed after the write."""
        flat: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for path, leaf in tree_items(state_tree):
            name = "/".join(map(str, path))
            flat[name] = _to_host(leaf)
            dtypes[name] = str(leaf.dtype).removeprefix("torch.")
        flat[_DTYPES_KEY] = np.array(json.dumps(dtypes))
        path = self.path(step)

        def write():
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)   # file handle: no suffix appended
            os.replace(tmp, path)
            self._gc()

        self.wait()  # never let two writers race on the same tmp path
        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return path

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            try:
                os.remove(self.path(s))
            except OSError:
                pass

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"ckpt_(\d+)\.npz$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree):
        """The checkpoint of ``step`` in the structure of ``target_tree``,
        each leaf cast to its target's dtype and placed on its target's
        device; a leaf whose shape differs from its target's raises
        ``ValueError``, a missing one ``KeyError``."""
        self.wait()
        with np.load(self.path(step)) as z:
            dtypes = (json.loads(str(z[_DTYPES_KEY]))
                      if _DTYPES_KEY in z.files else {})

            def build(tree, prefix=()):
                if isinstance(tree, dict):
                    return {k: build(v, prefix + (str(k),))
                            for k, v in tree.items()}
                name = "/".join(prefix)
                if name not in z.files:
                    raise KeyError(f"checkpoint missing leaf {name}")
                arr = z[name]
                if tuple(arr.shape) != tuple(tree.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: ckpt {arr.shape} vs "
                        f"target {tuple(tree.shape)}")
                return _from_host(arr, dtypes.get(name)).to(
                    device=tree.device, dtype=tree.dtype)

            return build(target_tree)


class FaultInjector:
    """Deterministic failure schedule for fault-tolerance runs: raises
    RuntimeError at configured steps (once each).

    :meth:`repro_torch.reliability.CheckpointSpec.injector` maps a compiled
    reliability timeline's outage start times onto training steps and
    returns one of these, so the schedule that drains simulated capacity
    crashes the real training loop (:mod:`repro_torch.launch.train`)."""

    def __init__(self, fail_at: List[int]):
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


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
