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
back. A sharded tree (DTensor leaves, :mod:`repro_torch.train.trainer` on
a mesh) is saved whole: every rank gathers each leaf (c10d all-gathers
over the mesh dims that shard it, the inner first:
:func:`~repro_torch.parallel.sharding.gather_whole`; collectives, so every
rank calls ``save``), rank 0 alone writes, and the others wait for
its write at their next ``wait`` (which ``save`` and ``restore`` call
first). ``restore`` places each leaf with the given shardings on any mesh
(or on none), so a checkpoint written on one mesh restores onto another
bit for bit. ``restore`` reads each stored member of the ``.npz`` with one
read into a reused host buffer (pinned for a card target), checks its
CRC-32 against the archive's, and copies it to its device, where
``np.load`` reads a member in 256 KiB pieces into fresh memory
(``tools/bench_restore.py`` times the two).

The training loop in :mod:`repro_torch.launch.train` wraps this with
crash-restart: failures (injected ones included) roll back to the latest
checkpoint, and the deterministic data pipeline replays from the restored
step.
"""
from __future__ import annotations

import json
import math
import os
import re
import struct
import threading
import zipfile
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_items
from repro_torch.parallel import sharding as Sh

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


class _NpzReader:
    """The members of an ``.npz`` that ``np.savez`` wrote (stored, not
    deflated), each read with one ``readinto`` into a host buffer that is
    reused from member to member (pinned with ``pin``), its CRC-32 checked
    against the archive's. A member is valid until the next is read."""

    def __init__(self, path: str, pin: bool):
        self.f = open(path, "rb")
        self.zip = zipfile.ZipFile(self.f)
        self.names = {i.filename[:-4] for i in self.zip.infolist()
                      if i.filename.endswith(".npy")}
        self.pin = pin
        self.buf: Optional[torch.Tensor] = None

    def close(self) -> None:
        self.zip.close()
        self.f.close()

    def read(self, name: str) -> np.ndarray:
        info = self.zip.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"checkpoint leaf {name} is compressed; "
                             "np.savez stores its members")
        f = self.f
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise ValueError(f"checkpoint leaf {name}: no local header")
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            local[26:30]))
        f.seek(start)
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (
            np.lib.format.read_array_header_1_0(f) if version == (1, 0)
            else np.lib.format.read_array_header_2_0(f))
        head_len = f.tell() - start
        f.seek(start)
        crc = zlib.crc32(f.read(head_len))
        nbytes = math.prod(shape) * dtype.itemsize
        if dtype.hasobject or head_len + nbytes != info.file_size:
            raise ValueError(f"checkpoint leaf {name}: {dtype}, "
                             f"{head_len + nbytes} bytes of {info.file_size}")
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                   pin_memory=self.pin)
        data = self.buf.numpy()[:nbytes]
        if f.readinto(memoryview(data)) != nbytes or \
                zlib.crc32(data, crc) != info.CRC:
            raise ValueError(f"checkpoint leaf {name}: truncated or corrupt")
        if fortran:
            return data.view(dtype).reshape(shape[::-1]).T
        return data.view(dtype).reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._barrier = False   # a sharded save: the ranks meet at wait()
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    # ------------------------------------------------------------- save
    def save(self, step: int, state_tree, block: bool = False) -> str:
        """Copies every leaf to the host now (so the caller may go on
        updating the tree), then writes ``.tmp`` and renames it into place
        on a thread, or here with ``block``; the oldest checkpoints beyond
        ``keep_last`` are removed after the write. DTensor leaves are
        gathered whole first, on every rank, one at a time; only rank 0
        writes."""
        sharded = any(isinstance(leaf, DTensor)
                      for _, leaf in tree_items(state_tree))
        writer = not sharded or dist.get_rank() == 0
        flat: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for path, leaf in tree_items(state_tree):
            name = "/".join(map(str, path))
            if isinstance(leaf, DTensor):
                leaf = Sh.gather_whole(leaf)
            if writer:
                flat[name] = _to_host(leaf)
            dtypes[name] = str(leaf.dtype).removeprefix("torch.")
        flat[_DTYPES_KEY] = np.array(json.dumps(dtypes))
        path = self.path(step)
        self.wait()  # never let two writers race on the same tmp path
        self._barrier = sharded
        if not writer:
            if block:
                self.wait()
            return path

        def write():
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)   # file handle: no suffix appended
            os.replace(tmp, path)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            if block:
                self.wait()
        return path

    def wait(self) -> None:
        """Waits for this rank's write in flight and, after a sharded
        save, for every rank (rank 0's write included)."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._barrier:
            self._barrier = False
            dist.barrier()

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

    def restore(self, step: int, target_tree, shardings=None):
        """The checkpoint of ``step`` in the structure of ``target_tree``,
        each leaf cast to its target's dtype and placed on its target's
        device; with ``shardings`` (a tree of ``target_tree``'s structure
        whose leaves are :class:`~repro_torch.parallel.sharding.
        NamedSharding`, or ``None`` for a plain leaf) as a DTensor with
        those placements on their mesh, each rank keeping its blocks of
        the file's leaf. A leaf whose shape differs from its target's
        raises ``ValueError``, a missing one ``KeyError``."""
        self.wait()
        pin = any(t.device.type == "cuda" for _, t in tree_items(target_tree))
        z = _NpzReader(self.path(step), pin)
        try:
            dtypes = (json.loads(str(z.read(_DTYPES_KEY)))
                      if _DTYPES_KEY in z.names else {})

            def build(tree, sh, prefix=()):
                if isinstance(tree, dict):
                    return {k: build(v, None if sh is None else sh[k],
                                     prefix + (str(k),))
                            for k, v in tree.items()}
                name = "/".join(prefix)
                if name not in z.names:
                    raise KeyError(f"checkpoint missing leaf {name}")
                arr = z.read(name)
                if tuple(arr.shape) != tuple(tree.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: ckpt {arr.shape} vs "
                        f"target {tuple(tree.shape)}")
                # a copy: the reader's buffer holds the next leaf next
                t = _from_host(arr, dtypes.get(name)).to(
                    device=tree.device, dtype=tree.dtype, copy=True)
                return t if sh is None else Sh.distribute(t, sh)

            return build(target_tree, shardings)
        finally:
            z.close()


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
