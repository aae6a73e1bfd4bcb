"""Padding/stacking for the batched engine, and the carry onto the device.

Mirrors :mod:`repro.core.batching`. A grid of experiment points is
heterogeneous: each entry has its own workload length, capacity-schedule
length and attempt tensors, while ``vdes.simulate_ensemble`` wants one
rectangular ``[R, ...]`` batch:

  - :func:`pad_workloads` — pack ragged workloads into ``[R, N_max, ...]``
    numpy columns (padding pipelines arrive past any horizon and are inert);
  - :func:`stack_scenarios` — pack per-entry compiled scenarios into the
    scenario kwargs of ``simulate_ensemble`` (schedules padded with no-op
    change points, attempts padded with 1, per-attempt service tensors
    padded to a common attempt-slot width);
  - :func:`to_tensors` — carry those numpy dicts (this module's or the
    reference's) onto a device in the engine's dtypes;
  - :func:`batch_trace` — slice one entry's result back out as a
    :class:`repro_torch.core.model.SimTrace`.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import model as M

# arrival sentinel: far beyond any horizon but finite in f32, so padded
# pipelines stay _NOT_ARRIVED until the clock reaches it without tripping
# the INF exit check
PAD_ARRIVAL = 3.0e37


def pad_workloads(wls: Sequence[M.Workload], platform,
                  n_max: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack workloads into the positional ``[R, ...]`` columns of
    ``vdes.simulate_ensemble``: arrival / n_tasks / task_res / service /
    priority, plus ``n_max``. All workloads must share ``max_tasks``.
    ``platform`` is one :class:`PlatformConfig` or a per-entry sequence
    (grid points may differ in datastore parameters)."""
    T = {w.max_tasks for w in wls}
    if len(T) != 1:
        raise ValueError(f"workloads disagree on max_tasks: {sorted(T)}")
    n_max = n_max if n_max is not None else max(w.n for w in wls)
    plats = (list(platform) if isinstance(platform, (list, tuple))
             else [platform] * len(wls))

    def pad(w: M.Workload, plat: M.PlatformConfig):
        p = n_max - w.n
        svc = w.service_time(plat.datastore)
        return (
            np.pad(w.arrival, (0, p),
                   constant_values=PAD_ARRIVAL).astype(np.float32),
            np.pad(w.n_tasks, (0, p), constant_values=1),
            np.pad(w.task_res, ((0, p), (0, 0))),
            np.pad(svc, ((0, p), (0, 0))).astype(np.float32),
            np.pad(w.priority, (0, p)),
        )

    arrival, n_tasks, task_res, service, priority = (
        np.stack(col) for col in zip(*[pad(w, p) for w, p in zip(wls, plats)]))
    return dict(arrival=arrival, n_tasks=n_tasks, task_res=task_res,
                service=service, priority=priority, n_max=n_max)


def stack_scenarios(compiled, n_max: int, horizon_s: float,
                    services=None, record_attempts: bool = True) -> dict:
    """Pad/stack per-entry compiled scenarios into the ``[R, ...]`` scenario
    kwargs of ``vdes.simulate_ensemble`` (``attempts`` / ``cap_times`` /
    ``cap_vals`` / ``backoff``, plus ``attempt_service`` and the static
    ``n_attempt_slots`` when any entry resamples retry durations, and
    ``fail_holds_frac [R]`` when any entry shortens failing attempts).

    Schedules of different lengths are padded with no-op change points past
    the horizon; workloads shorter than ``n_max`` pad their attempts with 1.
    When some entries carry an ``attempt_service [N, T, A]`` tensor and
    others don't, ``services`` must supply each entry's base ``[N, T]``
    service matrix so the missing ones broadcast to "every attempt re-runs
    at the base duration" (exactly the non-resampled semantics). Entries
    without partial-progress failures get fraction 1.0. An entry with a
    closed-loop controller is rejected: that stage is not ported yet.
    """
    if any(getattr(c, "controller", None) is not None for c in compiled):
        raise NotImplementedError(
            "stack_scenarios: closed-loop controllers are not ported to "
            "repro_torch yet")
    K = max(c.cap_times.shape[0] for c in compiled)
    slot_widths = [c.attempt_service.shape[2] for c in compiled
                   if getattr(c, "attempt_service", None) is not None]
    A = max(slot_widths) if slot_widths else 0
    cts, cvs, atts, bos, asvs = [], [], [], [], []
    for i, c in enumerate(compiled):
        sched = c.schedule.padded(K, horizon_s)
        cts.append(sched.times)
        cvs.append(sched.caps)
        a = np.asarray(c.attempts, np.int64)
        n_pad = n_max - a.shape[0]
        atts.append(np.pad(a, ((0, n_pad), (0, 0)), constant_values=1))
        bos.append(np.asarray(c.backoff, np.float64))
        if A:
            asv = getattr(c, "attempt_service", None)
            if asv is None:
                if services is None:
                    raise ValueError(
                        "some entries resample retry durations "
                        "(attempt_service) and some don't — pass services= "
                        "with each entry's base [N, T] service matrix")
                asv = np.repeat(
                    np.asarray(services[i], np.float64)[..., None], A, -1)
            elif asv.shape[2] < A:
                # the engine clips the attempt index at A-1, so repeating
                # the last slot preserves each entry's semantics exactly
                asv = np.concatenate(
                    [asv, np.repeat(asv[..., -1:], A - asv.shape[2], -1)], -1)
            asvs.append(np.pad(np.asarray(asv, np.float64),
                               ((0, n_pad), (0, 0), (0, 0))))
    out = dict(attempts=np.stack(atts).astype(np.int32),
               cap_times=np.stack(cts).astype(np.float32),
               cap_vals=np.stack(cvs).astype(np.int32),
               backoff=np.stack(bos).astype(np.float32))
    if A:
        out["attempt_service"] = np.stack(asvs).astype(np.float32)
    fracs = np.array([float(getattr(c, "fail_holds_frac", 1.0))
                      for c in compiled], np.float32)
    if (fracs < 1.0).any():
        out["fail_holds_frac"] = fracs
    # per-attempt recording slots: enough for the largest requested attempt
    # count (and every resampled slot), so accounting stays exact. With no
    # retries anywhere the single-attempt records already are exact.
    slots = int(max(int(out["attempts"].max()), A))
    if record_attempts and slots > 1:
        out["n_attempt_slots"] = slots
    return out


# the engine's dtypes for every tensor kwarg of simulate_ensemble: f32
# times, i32 indices and capacities (as the reference engine's)
_TENSOR_DTYPES = dict(
    arrival=torch.float32, n_tasks=torch.int32, task_res=torch.int32,
    service=torch.float32, priority=torch.float32, attempts=torch.int32,
    cap_times=torch.float32, cap_vals=torch.int32, backoff=torch.float32,
    attempt_service=torch.float32, fail_holds_frac=torch.float32)


def to_tensors(cols: dict, device) -> dict:
    """The numpy columns of :func:`pad_workloads` / :func:`stack_scenarios`
    (this module's or the reference's — the layouts are the same) as the
    tensors ``vdes.simulate_ensemble`` consumes, on ``device``: f32 times,
    i32 indices, counts and capacities. ``n_max`` is dropped and
    ``n_attempt_slots`` kept as an int; a key of a stage this port does not
    have yet (a controller, a fleet, ...) raises."""
    out = {}
    for k, v in cols.items():
        if k == "n_max":
            continue
        if k == "n_attempt_slots":
            out[k] = int(v)
        elif k in _TENSOR_DTYPES:
            out[k] = torch.as_tensor(np.ascontiguousarray(v),
                                     dtype=_TENSOR_DTYPES[k], device=device)
        else:
            raise NotImplementedError(
                f"to_tensors: {k!r} belongs to an engine stage that is not "
                "ported to repro_torch yet")
    return out


def batch_trace(out: dict, idx: int, wl: M.Workload,
                capacities: np.ndarray,
                with_scenario: bool = True) -> M.SimTrace:
    """Slice entry ``idx`` of a ``simulate_ensemble`` result back into a
    numpy :class:`SimTrace` for ``wl`` (dropping padded pipelines). With
    ``with_scenario=False`` the attempt/completion columns are omitted so
    the trace is indistinguishable from a plain single-replica run."""
    n = wl.n

    def sl(k, dtype=np.float64):
        if not with_scenario and k not in ("start", "finish", "ready"):
            return None
        if k not in out:
            return None
        return out[k][idx][:n].cpu().numpy().astype(dtype)

    return M.SimTrace(
        start=sl("start"), finish=sl("finish"), ready=sl("ready"),
        n_tasks=wl.n_tasks.astype(np.int64), task_res=wl.task_res,
        task_type=wl.task_type, arrival=np.asarray(wl.arrival, np.float64),
        capacities=np.asarray(capacities, np.int64),
        attempts=sl("attempts", np.int64), completed=sl("done", bool),
        att_start=sl("att_start"), att_finish=sl("att_finish"),
        waves=int(out["waves"][idx]),
    )
