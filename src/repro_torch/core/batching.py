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
    padded to a common attempt-slot width, controllers padded with the
    all-zero disabled row);
  - :func:`stack_fleets`, :func:`stack_probes`, :func:`stack_reliability` —
    the same for the lifecycle, telemetry and reliability stages (inert
    padding rows for entries without them);
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
    priority, plus ``n_max``. Workloads of fewer tasks than the batch's
    largest ``max_tasks`` get empty task columns (resource 0, service 0)
    that no pipeline reaches, its ``n_tasks`` ending it first;
    :func:`batch_trace` cuts them off again. (The reference raises there,
    and its batched engine falls back to the host.) ``platform`` is one
    :class:`PlatformConfig` or a per-entry sequence (grid points may
    differ in datastore parameters)."""
    T = max(w.max_tasks for w in wls)
    n_max = n_max if n_max is not None else max(w.n for w in wls)
    plats = (list(platform) if isinstance(platform, (list, tuple))
             else [platform] * len(wls))

    def pad(w: M.Workload, plat: M.PlatformConfig):
        p, q = n_max - w.n, T - w.max_tasks
        svc = w.service_time(plat.datastore)
        return (
            np.pad(w.arrival, (0, p),
                   constant_values=PAD_ARRIVAL).astype(np.float32),
            np.pad(w.n_tasks, (0, p), constant_values=1),
            np.pad(w.task_res, ((0, p), (0, q))),
            np.pad(svc, ((0, p), (0, q))).astype(np.float32),
            np.pad(w.priority, (0, p)),
        )

    arrival, n_tasks, task_res, service, priority = (
        np.stack(col) for col in zip(*[pad(w, p) for w, p in zip(wls, plats)]))
    return dict(arrival=arrival, n_tasks=n_tasks, task_res=task_res,
                service=service, priority=priority, n_max=n_max)


def stack_scenarios(compiled, n_max: int, horizon_s: float,
                    services=None, record_attempts: bool = True,
                    record_ctrl: bool = True) -> dict:
    """Pad/stack per-entry CompiledScenarios into the ``[R, ...]`` scenario
    kwargs of ``vdes.simulate_ensemble`` (``attempts`` / ``cap_times`` /
    ``cap_vals`` / ``backoff``, plus ``attempt_service`` and the static
    ``n_attempt_slots`` when any entry resamples retry durations,
    ``controllers [R, C]`` — plus the static ``n_ctrl_slots`` for
    realized-timeline recording, opt-out via ``record_ctrl=False`` — when
    any entry carries a closed-loop ControllerParams tensor, and
    ``fail_holds_frac [R]`` when any entry shortens failing attempts).

    Schedules of different lengths are padded with no-op change points past
    the horizon; workloads shorter than ``n_max``, or of fewer tasks than
    the batch's largest, pad their attempts with 1 (and their resampled
    services with 0), as :func:`pad_workloads` pads their task columns.
    When some entries carry an ``attempt_service [N, T, A]`` tensor and
    others don't, ``services`` must supply each entry's base ``[N, T]``
    service matrix so the missing ones broadcast to "every attempt re-runs
    at the base duration" (exactly the non-resampled semantics). Entries
    without a controller get the all-zero disabled row; entries without
    partial-progress failures get fraction 1.0 — both exactly the
    no-scenario semantics.
    """
    K = max(c.cap_times.shape[0] for c in compiled)
    T = max(np.shape(c.attempts)[1] for c in compiled)
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
        atts.append(np.pad(a, ((0, n_pad), (0, T - a.shape[1])),
                           constant_values=1))
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
                # engines clip the attempt index at A-1, so repeating the
                # last slot preserves each entry's semantics exactly
                asv = np.concatenate(
                    [asv, np.repeat(asv[..., -1:], A - asv.shape[2], -1)], -1)
            asvs.append(np.pad(np.asarray(asv, np.float64),
                               ((0, n_pad), (0, T - asv.shape[1]), (0, 0))))
    out = dict(attempts=np.stack(atts).astype(np.int32),
               cap_times=np.stack(cts).astype(np.float32),
               cap_vals=np.stack(cvs).astype(np.int32),
               backoff=np.stack(bos).astype(np.float32))
    if A:
        out["attempt_service"] = np.stack(asvs).astype(np.float32)
    ctrls = [getattr(c, "controller", None) for c in compiled]
    if any(ct is not None for ct in ctrls):
        from repro_torch.core.des import ctrl_tick_bound
        from repro_torch.ops.capacity import disabled_controller
        nres = out["cap_vals"].shape[2]
        C = disabled_controller(nres).shape[0]
        rows = []
        for ct in ctrls:
            if ct is None:
                rows.append(disabled_controller(nres))
            elif ct.shape != (C,):
                raise ValueError(
                    f"controller tensor shape {ct.shape} does not match the "
                    f"batch's ({C},) = CTRL_HEADER + CTRL_FIELDS * {nres}")
            else:
                rows.append(np.asarray(ct, np.float32))
        out["controllers"] = np.stack(rows)
        # realized-timeline recording: one [R, E, 1+nres] action buffer, E
        # the largest tick grid in the batch (its own opt-out, record_ctrl)
        if record_ctrl:
            slots_ctrl = max(ctrl_tick_bound(ct) for ct in ctrls
                             if ct is not None)
            if slots_ctrl > 0:
                out["n_ctrl_slots"] = slots_ctrl
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


def stack_fleets(fleets, n_max: int) -> dict:
    """Pad/stack per-entry :class:`~repro_torch.ops.scenario.CompiledFleet`\\ s
    (None entries allowed) into the fleet kwargs of
    ``vdes.simulate_ensemble``: ``fleets [R, M, FLEET_FIELDS]``, ``trig
    [R, TRIG_FIELDS]``, ``obs_noise``/``drift_inc [R, E, M]``, ``pool_gain
    [R, P]``, ``pool_base [R]``, ``n_pool_eff [R]``.

    Entries are padded to the batch's common (M, E, P): extra model rows
    are all-zero (zero drift, zero threshold margin — they never trigger),
    extra tick rows are unreachable (each entry's own ``t_end`` exhausts
    its grid first), extra pool slots are gated off by ``n_pool_eff``.
    Entries WITHOUT a fleet get the all-zero disabled ``trig`` row
    (interval <= 0 turns the stage off — exactly the no-fleet semantics)
    and ``pool_base = n_max`` (no latent rows).
    """
    from repro_torch.core.des import TRIG_FIELDS
    from repro_torch.core.metrics import FLEET_FIELDS
    live = [f for f in fleets if f is not None]
    if not live:
        return {}
    M_ = max(f.n_models for f in live)
    E = max(f.n_ticks for f in live)
    P = max(f.n_pool for f in live)
    fl, tg, ob, ji, pg, pb, pe = [], [], [], [], [], [], []
    for f in fleets:
        if f is None:
            fl.append(np.zeros((M_, FLEET_FIELDS), np.float32))
            tg.append(np.zeros(TRIG_FIELDS, np.float32))
            ob.append(np.zeros((E, M_), np.float32))
            ji.append(np.zeros((E, M_), np.float32))
            pg.append(np.zeros(P, np.float32))
            pb.append(n_max)
            pe.append(0)
            continue
        m_pad, e_pad, p_pad = (M_ - f.n_models, E - f.n_ticks,
                               P - f.n_pool)
        fl.append(np.pad(np.asarray(f.fleet, np.float32),
                         ((0, m_pad), (0, 0))))
        tg.append(np.asarray(f.trig, np.float32))
        ob.append(np.pad(np.asarray(f.obs_noise, np.float32),
                         ((0, e_pad), (0, m_pad))))
        ji.append(np.pad(np.asarray(f.drift_inc, np.float32),
                         ((0, e_pad), (0, m_pad))))
        pg.append(np.pad(np.asarray(f.pool_gain, np.float32), (0, p_pad)))
        pb.append(f.pool_base)
        pe.append(f.n_pool)
    return dict(fleets=np.stack(fl), trig=np.stack(tg),
                obs_noise=np.stack(ob), drift_inc=np.stack(ji),
                pool_gain=np.stack(pg),
                pool_base=np.asarray(pb, np.int32),
                n_pool_eff=np.asarray(pe, np.int32))


def stack_probes(probes, fleets=None) -> dict:
    """Pad/stack per-entry :class:`~repro_torch.obs.probes.CompiledProbe`\\ s
    (None entries allowed) into the probe kwargs of
    ``vdes.simulate_ensemble``: ``probes [R, PROBE_FIELDS]`` headers plus
    the static ``n_probe_slots`` (the batch's largest tick grid — each
    entry's own ``t_end`` exhausts its grid first, so extra rows stay NaN).
    Entries WITHOUT a probe get the all-zero disabled header (interval <= 0
    turns the stage off, exactly the no-probe semantics). ``fleets`` (the
    entries' CompiledFleets, None allowed) fills each header's ``n_models``
    so the fleet min/max reductions mask to the entry's own unpadded model
    rows."""
    from repro_torch.core.des import PROBE_FIELDS, PROBE_N_MODELS
    live = [p for p in probes if p is not None]
    if not live:
        return {}
    fleets = fleets if fleets is not None else [None] * len(probes)
    rows = []
    for p, f in zip(probes, fleets):
        if p is None:
            rows.append(np.zeros(PROBE_FIELDS, np.float32))
            continue
        hdr = np.asarray(p.header, np.float32).copy()
        hdr[PROBE_N_MODELS] = np.float32(f.n_models if f is not None else 0)
        rows.append(hdr)
    return dict(probes=np.stack(rows),
                n_probe_slots=max(p.n_ticks for p in live))


def stack_reliability(rels) -> dict:
    """Pad/stack per-entry
    :class:`~repro_torch.reliability.compile.CompiledReliability`\\ s (None
    entries allowed) into the reliability kwargs of
    ``vdes.simulate_ensemble``: ``rel_times [R, RV]`` f32, ``rel_deltas
    [R, RV, R]`` i32, plus the static ``n_rel_slots`` (the batch's largest
    event count). Padding rows carry the never-firing sentinel time
    (``des.CTRL_INF``) and a zero delta, so entries WITHOUT reliability —
    or with fewer events — apply nothing: exactly the disabled semantics.
    """
    from repro_torch.core.des import CTRL_INF
    live = [r for r in rels if r is not None and r.n_events > 0]
    if not live:
        return {}
    RV = max(r.n_events for r in live)
    nres = live[0].deltas.shape[1]
    ts, ds = [], []
    for r in rels:
        n = r.n_events if r is not None else 0
        ts.append(np.pad(np.asarray(r.times, np.float32) if n else
                         np.zeros(0, np.float32), (0, RV - n),
                         constant_values=CTRL_INF))
        ds.append(np.pad(np.asarray(r.deltas, np.int64) if n else
                         np.zeros((0, nres), np.int64),
                         ((0, RV - n), (0, 0))))
    return dict(rel_times=np.stack(ts), rel_deltas=np.stack(ds).astype(
        np.int32), n_rel_slots=RV)


# the engine's dtypes for every tensor kwarg of simulate_ensemble: f32
# times, i32 indices and capacities (as the reference engine's)
_TENSOR_DTYPES = dict(
    arrival=torch.float32, n_tasks=torch.int32, task_res=torch.int32,
    service=torch.float32, priority=torch.float32, attempts=torch.int32,
    cap_times=torch.float32, cap_vals=torch.int32, backoff=torch.float32,
    attempt_service=torch.float32, fail_holds_frac=torch.float32,
    controllers=torch.float32, fleets=torch.float32, trig=torch.float32,
    obs_noise=torch.float32, drift_inc=torch.float32,
    pool_gain=torch.float32, pool_base=torch.int32, n_pool_eff=torch.int32,
    probes=torch.float32, rel_times=torch.float32, rel_deltas=torch.int32)
# the static sizes of the recording buffers, kept as ints
_STATIC_INTS = ("n_attempt_slots", "n_ctrl_slots", "n_probe_slots",
                "n_rel_slots")


def to_tensors(cols: dict, device) -> dict:
    """The numpy columns of :func:`pad_workloads` and the ``stack_*``
    functions (this module's or the reference's — the layouts are the same)
    as the tensors ``vdes.simulate_ensemble`` consumes, on ``device``: f32
    times, i32 indices, counts and capacities. ``n_max`` is dropped and the
    buffer sizes (``n_*_slots``) kept as ints; an unknown key raises."""
    out = {}
    for k, v in cols.items():
        if k == "n_max":
            continue
        if k in _STATIC_INTS:
            out[k] = int(v)
        elif k in _TENSOR_DTYPES:
            out[k] = torch.as_tensor(np.ascontiguousarray(v),
                                     dtype=_TENSOR_DTYPES[k], device=device)
        else:
            raise ValueError(f"to_tensors: {k!r} is not an input of "
                             "simulate_ensemble")
    return out


def batch_trace(out: dict, idx: int, wl: M.Workload,
                capacities: np.ndarray,
                with_scenario: bool = True, fleet=None,
                probe=None, reliability=None) -> M.SimTrace:
    """Slice entry ``idx`` of a ``simulate_ensemble`` result back into a
    numpy :class:`SimTrace` for ``wl`` (dropping padded pipelines and
    task columns). With
    ``with_scenario=False`` the attempt/completion columns are omitted so
    the trace is indistinguishable from a plain single-replica run.
    ``fleet`` (the entry's :class:`~repro_torch.ops.scenario.CompiledFleet`)
    slices the entry's own model/tick/pool extents back out of the padded
    lifecycle tensors; ``probe`` (the entry's
    :class:`~repro_torch.obs.probes.CompiledProbe`) slices the probe buffer
    to the entry's own tick grid; ``reliability`` (the entry's
    :class:`~repro_torch.reliability.compile.CompiledReliability`) decodes
    the fired-event buffer into ``rel_times``/``rel_caps``."""
    from repro_torch.core.des import (fleet_trace_columns,
                                      unpack_ctrl_actions, unpack_rel_actions)
    n = wl.n

    def host(k, dtype=np.float64):
        return out[k][idx].cpu().numpy().astype(dtype)

    def sl(k, dtype=np.float64):
        if k not in out:
            return None
        v = host(k, dtype)[:n]
        return v[:, :wl.max_tasks] if v.ndim > 1 else v

    ctrl_times = ctrl_caps = None
    if with_scenario and "ctrl_act" in out:
        ctrl_times, ctrl_caps = unpack_ctrl_actions(host("ctrl_act"),
                                                    int(out["ctrl_n"][idx]))
    cols = {}
    arrival = np.asarray(wl.arrival, np.float64)
    if fleet is not None and "fleet_perf" in out:
        E, M_, P = fleet.n_ticks, fleet.n_models, fleet.n_pool
        arrival, cols = fleet_trace_columns(
            fleet, arrival, host("pool_arr")[:P], host("fleet_act"),
            int(out["fleet_n"][idx]), host("fleet_perf")[:E, :M_],
            host("fleet_stale")[:E, :M_])
    if probe is not None and "probe_vals" in out:
        cols.update(probe_times=np.asarray(probe.times, np.float64),
                    probe_vals=host("probe_vals")[:probe.n_ticks])
    if reliability is not None and reliability.n_events > 0 \
            and "rel_act" in out:
        rt, rc = unpack_rel_actions(host("rel_act"), int(out["rel_n"][idx]))
        cols.update(rel_times=rt, rel_caps=rc)
    return M.SimTrace(
        start=sl("start"), finish=sl("finish"), ready=sl("ready"),
        n_tasks=wl.n_tasks.astype(np.int64), task_res=wl.task_res,
        task_type=wl.task_type, arrival=arrival,
        capacities=np.asarray(capacities, np.int64),
        attempts=sl("attempts", np.int64) if with_scenario else None,
        completed=sl("done", bool)
        if with_scenario or fleet is not None else None,
        att_start=sl("att_start") if with_scenario else None,
        att_finish=sl("att_finish") if with_scenario else None,
        ctrl_times=ctrl_times, ctrl_caps=ctrl_caps,
        waves=int(out["waves"][idx]), **cols)
