"""Active-set compaction: the wave loop in segments over a windowed working
set (mirrors :mod:`repro.core.compaction`).

Most rows of a batch can do nothing at a given clock: finished pipelines
are inert forever, and pipelines that have not arrived yet are inert until
their arrival. This driver runs :func:`repro_torch.core.vdes.
simulate_ensemble` in *segments* (its ``resume`` / ``wave_budget`` /
``time_budget`` / ``return_state`` hooks make both a wave boundary and a
time boundary a bit-exact cut) over a compact working set per segment:

  - **finished replicas retire**: replicas whose loop finished leave the
    batch axis;
  - **DONE rows drop**: a DONE row has ``t_next == INF`` and never
    re-enters any stage;
  - **future arrivals defer**: a row with ``phase == NOT_ARRIVED`` and
    ``t_next > guard`` cannot affect any wave at a clock <= ``guard``. The
    driver picks a per-replica f32 ``guard``, defers every such row and
    passes the guard as the engine's ``time_budget``, so the loop stops
    before any wave that could tell the difference. Deferred rows re-enter
    once the window passes their ``t_next`` (retry-backoff rows and
    padding rows included).

The working width is the power-of-two bucket of the *active* set (arrived
and unfinished, plus at least the next whole arrival-time group), floored
at ``min_rows``; spare width takes the nearest future arrivals (whole
time groups only, so the guard never splits a tie).

The full-size state stays on the device. Each segment (``_segment_call``)
gathers the working set with advanced indexing, runs the wave loop with
``resume``, and scatters the carry back with ``index_put_``. Between
segments the host reads only ``running``, ``phase``, ``t_next`` and
``wave`` to choose the next window. The admission stage of every wave of
every segment launches ``fused_admission`` (``admission_sort="kernel"``)
on a CUDA device.

Bit-parity argument (twin-tested against the uncompacted engine and the
reference's driver):

  - dropped rows are DONE (inert forever) or deferred (inert until after
    the guard, and the segment stops at the guard);
  - gathers keep surviving rows in ascending original order, so the
    admission tie-break (pipeline id order) decides as in the full array;
    ``enq_wave`` rides in the carry;
  - padding slots duplicate a dropped row, which is inert in the segment,
    so the slot comes back with the values it gathered and its scatter
    writes the source row's own values back;
  - fleet retraining-pool rows are always kept (the fleet stage addresses
    them as the contiguous block ``[pool_base, pool_base + P)``) and
    ``pool_base`` is remapped to the block's compacted position;
  - the wave counter, every tick cursor and recording buffer ride the
    carry; a replica whose budget expires while others go on is frozen by
    the engine's per-replica commit, another exact cut.

``simulate_ensemble_compacted`` returns the result dict of
``vdes.simulate_ensemble`` (tensors on the device, full ``[R, N]``
shapes), assembled from the final state, so ``batching.batch_trace`` and
the engine take it unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import vdes
from repro_torch.core.batching import _TENSOR_DTYPES
from repro_torch.core.des import POLICY_FIFO
from repro_torch.device import resolve_device

_NOT_ARRIVED = vdes._NOT_ARRIVED
_DONE = vdes._DONE

#: state keys indexed by the pipeline-row axis (``vdes.simulate_ensemble``'s
#: per-row state); everything else in the state is per replica and passes
#: through whole
ROW_STATE_KEYS = ("phase", "task_idx", "t_next", "enq_wave", "attempt",
                  "start", "finish", "ready", "att_out",
                  "att_start", "att_finish")
#: ensemble inputs indexed by the pipeline-row axis (gathered per row)
ROW_INPUT_KEYS = ("arrival", "n_tasks", "task_res", "service", "priority",
                  "attempts", "attempt_service")
#: static (non-tensor) ensemble arguments passed to every segment
STATIC_KEYS = ("n_attempt_slots", "admission_sort", "n_ctrl_slots",
               "n_probe_slots")
_DTYPES = dict(_TENSOR_DTYPES, capacities=torch.int32, policies=torch.int32)


def _bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor, 1)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class CompactionLog:
    """What the driver did: segment count, gather events, and the
    (replicas, rows) working-shape timeline."""

    n_compactions: int = 0                 # windowed-gather boundaries
    n_segments: int = 0                    # segment calls
    shapes: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    live_rows: List[int] = dataclasses.field(default_factory=list)

    @property
    def distinct_shapes(self) -> int:
        return len(set(self.shapes))


def _segment_call(dev_inputs, full_state, rep_idx, row_idx, pool_base_w,
                  wave_budget, time_budget, *, policy, statics, device):
    """One segment: gather the working set from the full-size inputs and
    state on the device, run the wave loop under the wave/time budgets,
    scatter the carry back in place. Returns the working replicas'
    budget-free loop condition."""
    rows = (rep_idx[:, None], row_idx)
    w_inputs = {k: (v[rows] if k in ROW_INPUT_KEYS else v[rep_idx])
                for k, v in dev_inputs.items()}
    if pool_base_w is not None:
        w_inputs["pool_base"] = pool_base_w
    w_state = {k: (v[rows] if k in ROW_STATE_KEYS else v[rep_idx])
               for k, v in full_state.items()}
    res = vdes.simulate_ensemble(
        **w_inputs, policy=policy, **statics, resume=w_state,
        wave_budget=wave_budget, time_budget=time_budget, return_state=True,
        device=device)
    new = res["state"]
    # padding slots (and padding replicas) come back with the values they
    # gathered, so a duplicate target writes its source's own values: the
    # scatter's order among duplicates does not matter
    for k, v in full_state.items():
        v.index_put_(rows if k in ROW_STATE_KEYS else (rep_idx,), new[k])
    return res["running"]


def simulate_ensemble_compacted(
        arrival, n_tasks, task_res, service, priority, capacities,
        policy: int = POLICY_FIFO, *, segment_waves: int = 256,
        drain_waves: int = 256, min_rows: int = 8, lookahead: int = 24,
        log: Optional[CompactionLog] = None, device=None,
        **kw) -> Dict[str, torch.Tensor]:
    """Drop-in for :func:`vdes.simulate_ensemble` (the same tensor inputs,
    the same result keys and shapes, tensors on ``device``; ``None``: the
    card) that runs the wave loop in windowed, compacted segments.
    ``segment_waves`` caps the waves between boundaries while arrivals
    remain deferred (the time guard is the real cut there);
    ``drain_waves`` is a segment's budget once a replica's window holds
    everything left (guard = INF), so the width shrinks with the DONE rows;
    ``min_rows`` floors the bucketed working width; ``lookahead`` reserves
    window slots beyond the active set for future arrivals; ``log`` (a
    :class:`CompactionLog`) records what the driver did. Reliability
    timelines are refused, as the reference's engine refuses them."""
    if segment_waves < 1 or drain_waves < 1:
        raise ValueError("segment_waves and drain_waves must be >= 1, got "
                         f"{segment_waves}/{drain_waves}")
    if kw.get("rel_times") is not None:
        raise NotImplementedError(
            "reliability event timelines are not supported by the segmented "
            "compaction driver; run reliability specs on the 'torch' "
            "(one-call batched) engine")
    dev = resolve_device(device)
    log = log if log is not None else CompactionLog()
    statics = {k: kw.pop(k, None) for k in STATIC_KEYS}
    if statics["admission_sort"] is None:
        statics["admission_sort"] = "kernel"
    inputs = dict(arrival=arrival, n_tasks=n_tasks, task_res=task_res,
                  service=service, priority=priority, capacities=capacities)
    inputs.update({k: v for k, v in kw.items() if v is not None})
    dev_inputs = {k: torch.as_tensor(v, dtype=_DTYPES[k], device=dev)
                  for k, v in inputs.items()}
    has_fleet = "trig" in inputs
    P = int(dev_inputs["pool_gain"].shape[1]) if has_fleet else 0
    pool_base0 = (dev_inputs["pool_base"].cpu().numpy().astype(np.int64)
                  if has_fleet else None)

    R0, N0 = dev_inputs["arrival"].shape

    # the full-size state from a zero-budget call: the loop stops before
    # its first wave and returns the exact initial state
    res0 = vdes.simulate_ensemble(
        **dev_inputs, policy=policy, **statics,
        wave_budget=torch.zeros(R0, dtype=torch.int32, device=dev),
        return_state=True, device=dev)
    full_state = {k: v.clone() for k, v in res0["state"].items()}
    log.n_segments += 1
    log.shapes.append((R0, N0))

    running = res0["running"].cpu().numpy().copy()
    phase, t_next, wave = (full_state[k].cpu().numpy()
                           for k in ("phase", "t_next", "wave"))

    while True:
        # a replica goes on if its loop would (``running``) or if a
        # *deferred* row could still wake it: a NOT_ARRIVED row with a
        # finite t_next that was absent from the last working set (a
        # present one keeps ``running`` True, and a replica the engine
        # halted over starved QUEUED rows stays halted)
        live = running | ((phase == _NOT_ARRIVED)
                          & (t_next < np.inf)).any(axis=1)
        rep_live = np.flatnonzero(live)
        if not len(rep_live):
            break

        # ---- replica axis: live replicas, bucketed, padded with retired
        r_w = min(_bucket(len(rep_live)), R0)
        retired = np.flatnonzero(~live)
        rep_sel = np.concatenate([rep_live, retired[:r_w - len(rep_live)]])

        # ---- row axis, vectorized over the window's replica lanes:
        # forced = arrived and unfinished (and the fleet pool block);
        # optional = NOT_ARRIVED rows, windowed by t_next
        nl = len(rep_live)
        forced = np.zeros((r_w, N0), bool)
        forced[:nl] = (phase[rep_live] != _DONE) \
            & (phase[rep_live] != _NOT_ARRIVED)
        cols = np.arange(N0)[None, :]
        if has_fleet:
            pb = pool_base0[rep_sel][:, None]
            forced |= (cols >= pb) & (cols < pb + P)
        opt = np.zeros((r_w, N0), bool)
        opt[:nl] = (phase[rep_live] == _NOT_ARRIVED) & ~forced[:nl]

        # per-lane optionals by ascending t_next (others pushed to +inf;
        # stable, so ties keep column order): one argsort serves the width
        # choice, the window fill and the guard
        ts = np.full((r_w, N0), np.inf, np.float32)
        ts[:nl] = np.where(opt[:nl], t_next[rep_live], np.inf)
        order = np.argsort(ts, axis=1, kind="stable")
        ts_s = np.take_along_axis(ts, order, axis=1)
        n_opt = opt.sum(axis=1)
        fc = forced.sum(axis=1)

        # width: bucket of the largest active set plus at least the next
        # whole arrival-time group (so every live replica makes progress
        # within its guard)
        first_group = np.minimum((ts_s == ts_s[:, :1]).sum(axis=1)
                                 * (n_opt > 0), n_opt)
        need = int(np.max(fc + np.maximum(first_group,
                                          np.minimum(lookahead, n_opt)),
                          initial=0))
        width = min(_bucket(need, min_rows), N0)

        # fill spare width with the nearest future groups (whole groups
        # only: the guard must not split a t_next tie)
        m = np.minimum(width - fc, n_opt)
        last_in = np.take_along_axis(
            ts_s, np.maximum(m - 1, 0)[:, None], axis=1)[:, 0]
        split = (m > 0) & (m < n_opt) & (np.take_along_axis(
            ts_s, np.minimum(m, N0 - 1)[:, None], axis=1)[:, 0] == last_in)
        # a tie at the cut excludes that whole group
        m = np.where(split, (ts_s < last_in[:, None]).sum(axis=1), m)
        last_in = np.take_along_axis(
            ts_s, np.maximum(m - 1, 0)[:, None], axis=1)[:, 0]
        # guard: the last included t_next; nothing included -> just below
        # the first excluded arrival; nothing excluded -> +inf
        guard = np.full(r_w, np.inf, np.float32)
        cut = m < n_opt
        guard[cut] = np.where(
            m[cut] > 0, last_in[cut],
            np.nextafter(ts_s[cut, 0], -np.inf)).astype(np.float32)

        keep = np.zeros((r_w, N0), bool)
        np.put_along_axis(keep, order, cols < m[:, None], axis=1)
        keep = forced | (keep & opt)

        # kept columns first (ascending), the first dropped column pads
        kidx = np.argsort(~keep, axis=1, kind="stable")
        n_kept = keep.sum(axis=1)
        pad = kidx[np.arange(r_w), np.minimum(n_kept, N0 - 1)]
        row_idx = np.where(cols[:, :width] < n_kept[:, None],
                           kidx[:, :width], pad[:, None])
        new_pb = ((keep & (cols < pool_base0[rep_sel][:, None]))
                  .sum(axis=1) if has_fleet else None)
        log.live_rows.append(int(fc[:nl].max()) if nl else 0)

        # guard < INF: the time cut bounds the segment, the wave budget is
        # a backstop; guard == INF (the drain): short segments, so the
        # width shrinks with the DONE rows
        seg_w = np.where(np.isfinite(guard), segment_waves, drain_waves)

        def on_dev(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        run_w = _segment_call(
            dev_inputs, full_state, on_dev(rep_sel, torch.long),
            on_dev(row_idx, torch.long),
            on_dev(new_pb, torch.int32) if has_fleet else None,
            on_dev(wave[rep_sel] + seg_w, torch.int32),
            on_dev(guard, torch.float32), policy=policy, statics=statics,
            device=dev)
        log.n_segments += 1
        log.n_compactions += 1
        log.shapes.append((r_w, width))

        running[rep_sel] = run_w.cpu().numpy()
        phase, t_next, wave = (full_state[k].cpu().numpy()
                               for k in ("phase", "t_next", "wave"))

    # ---- the simulate_ensemble result dict from the final state (the
    # recording buffers ride the carry as they are)
    st = full_state
    res = dict(start=st["start"], finish=st["finish"], ready=st["ready"],
               attempts=st["att_out"], done=st["phase"] == _DONE,
               waves=st["wave"])
    if statics["n_attempt_slots"] is not None:
        res["att_start"] = st["att_start"]
        res["att_finish"] = st["att_finish"]
    if "controllers" in inputs and statics["n_ctrl_slots"]:
        res["ctrl_act"] = st["ctrl_act"]
        res["ctrl_n"] = st["ctrl_n"]
    if has_fleet:
        for k in ("fleet_perf", "fleet_stale", "fleet_act", "fleet_n",
                  "pool_arr", "pool_model", "pool_next"):
            res[k] = st[k]
    if "probes" in inputs and statics["n_probe_slots"]:
        res["probe_vals"] = st["probe_vals"]
        res["probe_n"] = st["p_tick"]
    return res
