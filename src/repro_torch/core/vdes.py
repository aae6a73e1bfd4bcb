"""Batched discrete-event engine in PyTorch (mirrors :mod:`repro.core.vdes`).

State is a struct-of-tensors over ``[R, N]`` (replicas x pipelines). Each
loop iteration — a **wave** — advances every replica's clock to its next
event time and retires *all* events at that instant, in four stages:

  1. **event selection** (``_select_events``): the next-event time
     ``t_star [R]`` is the minimum over pending task events and the next
     scheduled capacity change;
  2. **completion/retry** (``_completion_stage``): finishes release slots,
     successful attempts advance the pipeline, failed attempts re-enter the
     arrival path after a deterministic bounded exponential backoff
     ``min(base * mult**k, cap)``; arrivals and successor tasks enqueue;
  3. **control** (``_control_stage``): the pending piecewise-constant
     capacity change applies (a decrease never preempts: free goes
     negative and admission stalls until jobs drain);
  4. **admission** (``_admission_stage``): one ranked admission round per
     resource, by the hand-written CUDA kernel
     :func:`repro_torch.kernels.queue_scan.fused_admission`
     (``admission_sort="kernel"``) or its plain version
     (``admission_sort="dense"``).

The reference's closed-loop controller, reliability, fleet and probe
stages, its sort-based ``"fused"``/``"chained"`` rankings and its
segment-restart hooks are not ported yet.

**The replica axis.** The reference writes one replica and ``jax.vmap``s a
``lax.while_loop`` over it. The batched loop runs until every replica is
finished, and a finished replica is frozen: its state, its wave counter
included, stops changing. Here the replica axis is written out: each wave
evaluates the loop condition per replica into an ``active [R]`` mask,
computes the stages for all replicas, and commits each state field with
``torch.where(active, new, old)``. The host reads the mask only every
``sync_every`` waves; the waves a finished batch runs past its end are
inert, so the outputs do not depend on ``sync_every``.

**Exactness.** Times are float32, as in the reference. Every product is
rounded on its own (separate eager ops: no ``torch.compile``, no custom
kernel for the stage arithmetic, which would contract ``a + b*c`` into an
FMA), so on integer-time workloads the outputs equal the reference
engines' bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.des import (CTRL_INF, POLICY_FIFO, POLICY_PRIORITY,
                                  POLICY_SJF)
from repro_torch.device import resolve_device
from repro_torch.kernels.queue_scan import fused_admission
from repro_torch.kernels.ref import admission_mask_dense

INF = float(CTRL_INF)   # the ONE shared f32 "never" sentinel

# phases
_NOT_ARRIVED, _QUEUED, _RUNNING, _DONE = 0, 1, 2, 3

_NO_RETRY_BACKOFF = (0.0, 2.0, 3600.0)

ADMISSION_SORTS = ("kernel", "dense")


@dataclasses.dataclass(frozen=True)
class VWorkload:
    """Device-resident workload tensors (one replica). ``attempts`` is the
    pre-sampled service-attempt count per task for failure/retry scenarios
    (None = one attempt each)."""

    arrival: torch.Tensor    # [N] f32
    n_tasks: torch.Tensor    # [N] i32
    task_res: torch.Tensor   # [N, T] i32
    service: torch.Tensor    # [N, T] f32
    priority: torch.Tensor   # [N] f32
    attempts: Optional[torch.Tensor] = None   # [N, T] i32

    @staticmethod
    def from_workload(wl: M.Workload, platform: Optional[M.PlatformConfig] = None,
                      attempts: Optional[np.ndarray] = None,
                      device=None) -> "VWorkload":
        platform = platform or M.PlatformConfig()
        dev = resolve_device(device)

        def t(x, dt):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)

        return VWorkload(
            arrival=t(wl.arrival, torch.float32),
            n_tasks=t(wl.n_tasks, torch.int32),
            task_res=t(wl.task_res, torch.int32),
            service=t(wl.service_time(platform.datastore), torch.float32),
            priority=t(wl.priority, torch.float32),
            attempts=None if attempts is None
            else t(attempts, torch.int32),
        )


def simulate(vwl: VWorkload, capacities, policy: int = POLICY_FIFO,
             cap_times=None, cap_vals=None, backoff=None,
             attempt_service=None, policy_dyn=None,
             n_attempt_slots: Optional[int] = None,
             fail_holds_frac=None, admission_sort: str = "kernel",
             device=None) -> dict:
    """Run one replica: :func:`simulate_ensemble` with ``R = 1``. Returns
    start/finish/ready ``[N, T]`` (f32; NaN where a task does not exist or
    never ran), attempts, done and the wave count.

    ``cap_times [K]`` / ``cap_vals [K, nres]`` give a piecewise-constant
    capacity schedule (``cap_times[0]`` must be 0; ``capacities`` is
    ignored when given). ``backoff`` is the ``(base, mult, cap)`` retry
    delay triple. ``attempt_service [N, T, A]`` gives per-attempt service
    times (attempt ``k`` runs slot ``min(k, A-1)``). ``policy_dyn`` (an int)
    overrides ``policy``. With ``n_attempt_slots = A`` the per-attempt
    ``att_start``/``att_finish [N, T, A]`` are recorded too.
    ``fail_holds_frac`` makes a *failing* attempt hold its slot for only
    that fraction of its service time."""

    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    res = simulate_ensemble(
        one(vwl.arrival), one(vwl.n_tasks), one(vwl.task_res),
        one(vwl.service), one(vwl.priority), one(capacities), policy,
        attempts=one(vwl.attempts), cap_times=one(cap_times),
        cap_vals=one(cap_vals), backoff=one(backoff),
        policies=one(policy_dyn), attempt_service=one(attempt_service),
        n_attempt_slots=n_attempt_slots,
        fail_holds_frac=one(fail_holds_frac), admission_sort=admission_sort,
        device=device)
    return {k: v[0] for k, v in res.items()}


def simulate_to_trace(wl: M.Workload, platform: Optional[M.PlatformConfig] = None,
                      policy: int = POLICY_FIFO, scenario=None,
                      device=None) -> M.SimTrace:
    """Convenience: numpy Workload in, SimTrace out (single replica).
    ``scenario`` is a :class:`repro_torch.ops.scenario.CompiledScenario`."""
    platform = platform or M.PlatformConfig()
    att_start = att_finish = None

    def host(x, dtype=np.float64):
        return x.cpu().numpy().astype(dtype)

    if scenario is not None:
        vwl = VWorkload.from_workload(wl, platform, attempts=scenario.attempts,
                                      device=device)
        att_svc = scenario.attempt_service
        frac = float(scenario.fail_holds_frac)
        slots = int(max(np.max(scenario.attempts), 1,
                        att_svc.shape[2] if att_svc is not None else 1))
        if slots == 1:   # no retries: single-attempt records already exact
            slots = None
        res = simulate(vwl, platform.capacities, policy,
                       cap_times=scenario.cap_times,
                       cap_vals=scenario.cap_vals,
                       backoff=scenario.backoff, attempt_service=att_svc,
                       n_attempt_slots=slots,
                       fail_holds_frac=None if frac >= 1.0 else frac,
                       device=device)
        caps0 = np.asarray(scenario.cap_vals[0], np.int64)
        attempts = host(res["attempts"], np.int64)
        completed = host(res["done"], bool)
        if slots is not None:
            att_start = host(res["att_start"])
            att_finish = host(res["att_finish"])
    else:
        vwl = VWorkload.from_workload(wl, platform, device=device)
        res = simulate(vwl, platform.capacities, policy, device=device)
        caps0 = platform.capacities
        attempts = completed = None
    return M.SimTrace(
        start=host(res["start"]), finish=host(res["finish"]),
        ready=host(res["ready"]),
        n_tasks=wl.n_tasks.astype(np.int64),
        task_res=wl.task_res, task_type=wl.task_type,
        arrival=np.asarray(wl.arrival, np.float64),
        capacities=caps0, attempts=attempts, completed=completed,
        att_start=att_start, att_finish=att_finish,
        waves=int(res["waves"]))


def simulate_ensemble(arrival, n_tasks, task_res, service, priority,
                      capacities, policy: int = POLICY_FIFO,
                      attempts=None, cap_times=None, cap_vals=None,
                      backoff=None, policies=None, attempt_service=None,
                      n_attempt_slots: Optional[int] = None,
                      fail_holds_frac=None, admission_sort: str = "kernel",
                      sync_every: int = 64, device=None) -> dict:
    """arrival: [R, N]; task_res/service: [R, N, T]; capacities: [R, nres].

    Optional per-replica scenario tensors: ``attempts [R, N, T]``,
    ``cap_times [R, K]`` / ``cap_vals [R, K, nres]``, ``backoff [R, 3]``,
    ``attempt_service [R, N, T, A]`` (per-attempt resampled service times),
    ``fail_holds_frac [R]`` (slot-holding fraction of failing attempts) and
    ``policies [R]`` (i32: an admission policy per replica, overriding
    ``policy``). ``n_attempt_slots`` turns on per-attempt start/finish
    recording. Inputs may be numpy arrays or tensors; they are carried to
    ``device`` (``None``: the card) in the engine's dtypes — see
    :func:`repro_torch.core.batching.to_tensors`.

    ``admission_sort`` is ``"kernel"`` (the CUDA admission kernel; its
    plain version on CPU tensors) or ``"dense"`` (the plain version on any
    device — the on-card reference). ``sync_every`` is the number of waves
    between host reads of the loop condition.

    Returns tensors on ``device``: ``start``/``finish``/``ready
    [R, N, T]`` f32, ``attempts [R, N, T]`` i32 (executed admissions),
    ``done [R, N]`` bool, ``waves [R]`` i32, and with ``n_attempt_slots``
    ``att_start``/``att_finish [R, N, T, A]``."""
    dev = resolve_device(device)
    if admission_sort not in ADMISSION_SORTS:
        raise ValueError(f"unknown admission_sort {admission_sort!r}; "
                         f"expected one of {ADMISSION_SORTS}")
    if (cap_times is None) != (cap_vals is None):
        raise ValueError("cap_times and cap_vals must be given together")
    if int(sync_every) < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    f32, i32 = torch.float32, torch.int32

    def t(x, dt):
        return torch.as_tensor(x, dtype=dt, device=dev).contiguous()

    arrival = t(arrival, f32)
    n_tasks = t(n_tasks, i32)
    task_res = t(task_res, i32)
    service = t(service, f32)
    priority = t(priority, f32)
    R, N, T = task_res.shape
    if cap_times is None:
        cap_times = torch.zeros((R, 1), dtype=f32, device=dev)
        cap_vals = t(capacities, i32)[:, None, :]
    cap_times, cap_vals = t(cap_times, f32), t(cap_vals, i32)
    K, nres = cap_vals.shape[1], cap_vals.shape[2]
    bo = t(_NO_RETRY_BACKOFF if backoff is None else backoff, f32)
    bo = bo.expand(R, 3) if bo.dim() == 1 else bo
    bo0, bo1, bo2 = bo[:, 0:1], bo[:, 1:2], bo[:, 2:3]
    att_req = (torch.ones((R, N, T), dtype=i32, device=dev)
               if attempts is None else t(attempts, i32).clamp(min=1))
    pol = None if policies is None else t(policies, i32)[:, None]
    frac = None if fail_holds_frac is None else t(fail_holds_frac, f32)[:, None]
    if attempt_service is not None:
        asvc = t(attempt_service, f32)
        A_svc = asvc.shape[3]
        asvc = asvc.reshape(R, N, T * A_svc)
    rows = torch.arange(R, device=dev)
    ar_T = torch.arange(T, dtype=i32, device=dev)
    ar_res = torch.arange(nres, dtype=i32, device=dev)
    admit = fused_admission if admission_sort == "kernel" \
        else admission_mask_dense

    def take(x, col):
        """``x[r, i, col[r, i]]``: the row's current task column."""
        return x.gather(2, col.long()[..., None])[..., 0]

    def per_res(mask, res):
        """``[R, nres]`` count of rows in ``mask`` on each resource (the
        sentinel ``nres`` matches none)."""
        return (mask[..., None] & (res[..., None] == ar_res)).sum(
            1, dtype=i32)

    def onehot(col):
        return col[..., None] == ar_T

    s = dict(
        phase=torch.full((R, N), _NOT_ARRIVED, dtype=i32, device=dev),
        task_idx=torch.zeros((R, N), dtype=i32, device=dev),
        t_next=arrival.clone(),
        enq_wave=torch.zeros((R, N), dtype=i32, device=dev),
        attempt=torch.zeros((R, N), dtype=i32, device=dev),
        free=cap_vals[:, 0].clone(),
        cap_idx=torch.ones((R,), dtype=i32, device=dev),
        wave=torch.zeros((R,), dtype=i32, device=dev),
        start=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        finish=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        ready=torch.full((R, N, T), float("nan"), dtype=f32, device=dev),
        att_out=torch.zeros((R, N, T), dtype=i32, device=dev),
    )
    if n_attempt_slots is not None:
        for k in ("att_start", "att_finish"):
            s[k] = torch.full((R, N, T, n_attempt_slots), float("nan"),
                              dtype=f32, device=dev)
        ar_A = torch.arange(n_attempt_slots, dtype=i32, device=dev)

    # ------------------------------------------------------------ stages

    def _select_events(s):
        """Stage 1: the per-replica next-event time over task events and
        the next scheduled capacity change."""
        ci = s["cap_idx"]
        t_cap = torch.where(
            ci < K, cap_times.gather(1, ci.clamp(0, K - 1).long()[:, None])[:, 0],
            INF)
        return torch.minimum(s["t_next"].amin(1), t_cap), t_cap

    def _running(s, t_star):
        # exit when everything is done OR nothing can ever happen again
        return (s["phase"] != _DONE).any(1) & (t_star < INF)

    def _completion_stage(s, ts):
        """Stage 2: finishes release slots; failed attempts re-enter the
        arrival path after their backoff delay; successful ones advance the
        pipeline; arrivals and successor tasks enqueue."""
        phase, task_idx, t_next = s["phase"], s["task_idx"], s["t_next"]
        finishing = (phase == _RUNNING) & (t_next == ts)
        arriving = (phase == _NOT_ARRIVED) & (t_next == ts)
        tcl0 = task_idx.clamp(0, T - 1)
        s["free"] = s["free"] + per_res(finishing, take(task_res, tcl0))

        att = s["attempt"]
        retrying = finishing & (att + 1 < take(att_req, tcl0))
        succeeding = finishing & ~retrying
        delay = torch.minimum(bo0 * torch.pow(bo1, att.to(f32)), bo2)

        task_idx = task_idx + succeeding.to(i32)
        att = torch.where(retrying, att + 1, torch.where(succeeding, 0, att))
        done_now = succeeding & (task_idx >= n_tasks)
        to_queue = (succeeding & ~done_now) | arriving
        s["phase"] = torch.where(
            done_now, _DONE,
            torch.where(to_queue, _QUEUED,
                        torch.where(retrying, _NOT_ARRIVED, phase)))
        s["t_next"] = torch.where(succeeding | arriving, INF,
                                  torch.where(retrying, ts + delay, t_next))
        s["enq_wave"] = torch.where(to_queue, s["wave"][:, None],
                                    s["enq_wave"])
        s["task_idx"], s["attempt"] = task_idx, att
        s["ready"] = torch.where(
            onehot(task_idx.clamp(0, T - 1)) & to_queue[..., None],
            ts[..., None], s["ready"])

    def _control_stage(s, t_star, t_cap):
        """Stage 3: the pending scheduled capacity change applies."""
        ci = s["cap_idx"]
        cap_changing = (t_cap == t_star) & (ci < K)
        hi = ci.clamp(0, K - 1).long()
        lo = (ci - 1).clamp(0, K - 1).long()
        s["free"] = s["free"] + torch.where(
            cap_changing[:, None], cap_vals[rows, hi] - cap_vals[rows, lo], 0)
        s["cap_idx"] = ci + cap_changing.to(i32)

    def _admission_stage(s, ts):
        """Stage 4: one ranked admission round per resource, recording
        start/finish for admitted attempts."""
        att = s["attempt"]
        tcl = s["task_idx"].clamp(0, T - 1)
        queued = s["phase"] == _QUEUED
        res_q = torch.where(queued, take(task_res, tcl), nres)   # sentinel
        if attempt_service is None:
            svc = take(service, tcl)
        else:
            svc = take(asvc, tcl * A_svc + att.clamp(0, A_svc - 1))
        if pol is not None:
            pkey = torch.where(pol == POLICY_PRIORITY, -priority,
                               torch.where(pol == POLICY_SJF, svc, 0.0))
        elif policy == POLICY_PRIORITY:
            pkey = -priority
        elif policy == POLICY_SJF:
            pkey = svc
        else:
            pkey = torch.zeros((R, N), dtype=f32, device=dev)
        admitted = admit(res_q, pkey, s["enq_wave"], s["free"]) & queued

        # a failing attempt (known at admission from the pre-sampled attempt
        # tensor) may hold its slot for only a fraction of the service time
        if frac is None:
            dur = svc
        else:
            will_fail = (att + 1) < take(att_req, tcl)
            dur = torch.where(will_fail, frac * svc, svc)
        t_fin = ts + dur
        adm_col = onehot(tcl) & admitted[..., None]
        s["t_next"] = torch.where(admitted, t_fin, s["t_next"])
        s["phase"] = torch.where(admitted, _RUNNING, s["phase"])
        s["start"] = torch.where(adm_col, ts[..., None], s["start"])
        s["finish"] = torch.where(adm_col, t_fin[..., None], s["finish"])
        # executed attempts: a task stranded mid-retry reports the
        # admissions that actually happened
        s["att_out"] = s["att_out"] + adm_col.to(i32)
        s["free"] = s["free"] - per_res(admitted, res_q)
        if n_attempt_slots is not None:
            ka = att.clamp(0, n_attempt_slots - 1)
            adm_slot = adm_col[..., None] & (ka[..., None, None] == ar_A)
            s["att_start"] = torch.where(adm_slot, ts[..., None, None],
                                         s["att_start"])
            s["att_finish"] = torch.where(adm_slot, t_fin[..., None, None],
                                          s["att_finish"])

    # -------------------------------------------------------- wave loop

    def wave(s):
        """One wave for every replica, committed where the replica is still
        running (the vmap-of-while semantics); returns the new state."""
        t_star, t_cap = _select_events(s)
        active = _running(s, t_star)
        new = dict(s)
        ts = t_star[:, None]
        _completion_stage(new, ts)
        _control_stage(new, t_star, t_cap)
        _admission_stage(new, ts)
        new["wave"] = s["wave"] + 1
        return {k: torch.where(active.view((R,) + (1,) * (v.dim() - 1)),
                               v, s[k]) for k, v in new.items()}

    while True:
        for _ in range(int(sync_every)):
            s = wave(s)
        if not bool(_running(s, _select_events(s)[0]).any()):
            break

    res = dict(start=s["start"], finish=s["finish"], ready=s["ready"],
               attempts=s["att_out"], done=s["phase"] == _DONE,
               waves=s["wave"])
    if n_attempt_slots is not None:
        res["att_start"] = s["att_start"]
        res["att_finish"] = s["att_finish"]
    return res
