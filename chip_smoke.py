#!/usr/bin/env python3
"""Drive the PyTorch port of PipeSim on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. Setup: torch/CUDA versions, the card's name and power limit, the
   build of the kernel, and the workloads of phase 3.
2. The kernel against its plain PyTorch version on the card, exactly, over
   a grid of shapes, ties, sentinel shares and negative free slots.
3. The main path: a 32-replica Monte-Carlo ensemble of one-day ground-truth
   workloads (the paper's 44 s mean interarrival; the default 48 compute /
   32 learning nodes, the learning cluster cycling over 16/24/32/48; FIFO /
   PRIORITY / SJF; failures with retries and backoff everywhere,
   maintenance windows on half, resampled retry durations on a quarter)
   through ``simulate_ensemble`` on the card. Checks: every pipeline done,
   start >= ready, finish >= start, no resource ever runs more attempts
   than the largest capacity its schedule grants, the kernel was launched,
   and 4 replicas re-run through the plain admission are bit-identical.
   Every ``KEEP_EVERY``-th admission input of the run is kept; on those
   real inputs the kernel, its plain version and a library yardstick are
   compared and timed with CUDA events, beside each input's bound.
4. The single-replica path: ``simulate_to_trace`` -> ``flatten_trace`` ->
   ``summarize`` with a schedule, an SLO and cost rates, equal to the
   ensemble's replica.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HORIZON_S = 86400.0
N_REPLICAS = 32
LEARNING_CAPS = (16, 24, 32, 48)
DENSE_REPLICAS = (4, 9, 11, 14)     # every capacity, policy and scenario kind
KEEP_EVERY = 500     # keep every 500th admission input of the main path
# the kernel-vs-plain grid: replicas, rows, resources, sentinel shares
CHECK_R, CHECK_N = (1, 32), (1, 127, 128, 2500, 17000)
CHECK_NRES, CHECK_SENTINELS = (1, 2, 5), (0.0, 0.5, 0.9)
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and the f32 /
# int32 rate of the CUDA cores (the admission kernel does no tensor-core work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean time of one call on the card, by CUDA events over many calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def same_bits(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


# ------------------------------------------------------------ phase 2

def admission_case(rng, R, N, nres, sentinel_frac, float_keys, device):
    """Heavy ties in pkey and enq_wave (-0.0 beside 0.0 unless float keys),
    free from negative to about the segment size, a share of sentinels."""
    import torch
    res = rng.integers(0, nres, (R, N)).astype(np.int32)
    res[rng.random((R, N)) < sentinel_frac] = nres
    if float_keys:
        pkey = rng.choice(rng.exponential(50.0, 64), (R, N)).astype(np.float32)
    else:
        pkey = rng.integers(-2, 3, (R, N)).astype(np.float32)
        pkey[rng.random((R, N)) < 0.2] = -0.0
    wave = rng.integers(0, 4, (R, N)).astype(np.int32)
    free = rng.integers(-3, max(6, N // nres), (R, nres)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (res, pkey, wave, free)]


def sorted_admission(res_q, pkey, enq_wave, free):
    """The library yardstick: the admission mask from three chained stable
    ``torch.sort``s, a segmented seat count and an unsort scatter (the
    reference's ``"chained"`` ranking). Timed only; the port never calls
    it."""
    import torch
    R, N = res_q.shape
    o = torch.sort(enq_wave, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(pkey.gather(1, o), dim=1, stable=True).indices)
    o = o.gather(1, torch.sort(res_q.gather(1, o), dim=1, stable=True).indices)
    r_s = res_q.gather(1, o)
    pos = torch.arange(N, device=res_q.device).expand(R, N)
    is_start = torch.ones_like(r_s, dtype=torch.bool)
    is_start[:, 1:] = r_s[:, 1:] != r_s[:, :-1]
    seat = pos - torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    free_ext = torch.cat([free, torch.zeros_like(free[:, :1])], 1)
    adm = seat < free_ext.gather(1, r_s.long())
    return torch.zeros_like(adm).scatter_(1, o, adm) & (res_q < free.shape[1])


def admission_bound(res_q, free):
    """Least time for one admission round on this input, as ``(bytes_ms,
    ops_ms)``; the bound is the larger. Bytes: each input read once, the
    mask written once, over the memory rate. Operations: what the function
    needs, over the CUDA cores' rate — for each ordered pair of queued rows
    on one resource of one replica, a lexicographic (pkey, wave, id) test
    and a count (5 operations). Rows that are not queued need none; the
    kernel's compare of each queued row against every column is its own
    way, not the function's work."""
    R, N = res_q.shape
    nres = free.shape[1]
    nbytes = R * N * (4 + 4 + 4 + 1) + R * nres * 4
    res = res_q.cpu().numpy()
    q_by_res = np.stack([(res == r).sum(1) for r in range(nres)], 1)
    ops = 5.0 * (q_by_res.astype(np.float64) ** 2).sum()
    return nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3


def mask_err(got, want) -> int:
    """max |got - want| over two admission masks, as an integer (0 or 1)."""
    return int((got.int() - want.int()).abs().max())


def phase_kernels(torch, fused_admission, dense):
    """The kernel against its plain version over the grid; returns the
    largest difference (0, or it raises)."""
    rng = np.random.default_rng(11)
    n_cases = err = 0
    for R in CHECK_R:
        for N in CHECK_N:
            for nres in CHECK_NRES:
                for sent in CHECK_SENTINELS:
                    args = admission_case(rng, R, N, nres, sent,
                                          float_keys=(N + nres) % 2 == 1,
                                          device="cuda")
                    got = fused_admission(*args)
                    want = dense(*args)
                    err = max(err, mask_err(got, want))
                    if err:
                        raise AssertionError(
                            f"fused_admission differs from its plain version "
                            f"in {int((got != want).sum())} rows at R={R} "
                            f"N={N} nres={nres} sentinels={sent}")
                    n_cases += 1
    log(f"[2] fused_admission == admission_mask_dense exactly on {n_cases} "
        f"cases (R in {CHECK_R}, N in {CHECK_N}, nres in {CHECK_NRES}, "
        f"sentinel shares {CHECK_SENTINELS}; tied keys; negative free)")
    return err


class InputTap:
    """Stands in for ``fused_admission`` inside the engine: launches it and
    keeps a copy of every ``every``-th call's inputs."""

    def __init__(self, kernel, every):
        self.kernel, self.every = kernel, every
        self.calls, self.kept = 0, []

    def __call__(self, *args):
        if self.calls % self.every == 0:
            self.kept.append([a.clone() for a in args])
        self.calls += 1
        return self.kernel(*args)


def time_admission(torch, fused_admission, dense, kept):
    """On each kept input of the main path: the kernel and the
    ``torch.sort`` yardstick against the plain version, then the three
    timed with CUDA events, and the input's bound. Returns the means over
    the inputs (the mean launch of the run) and the largest difference."""
    rows, err = [], 0
    for a in kept:
        want = dense(*a)
        got = fused_admission(*a)
        err = max(err, mask_err(got, want))
        if err:
            raise AssertionError(
                f"fused_admission differs from its plain version in "
                f"{int((got != want).sum())} rows on a main-path input")
        if not bool(torch.equal(sorted_admission(*a), want)):
            raise AssertionError("the torch.sort yardstick differs on a "
                                 "main-path input")
        bytes_ms, ops_ms = admission_bound(a[0], a[3])
        rows.append(dict(
            queued=int((a[0] < a[3].shape[1]).sum()),
            ms=cuda_ms(lambda: fused_admission(*a), iters=100),
            plain_ms=cuda_ms(lambda: dense(*a), iters=20, warmup=3),
            library_ms=cuda_ms(lambda: sorted_admission(*a), iters=50),
            bytes_ms=bytes_ms, ops_ms=ops_ms))
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    bound_ms = float(np.mean([max(r["bytes_ms"], r["ops_ms"]) for r in rows]))
    kms = [r["ms"] for r in rows]
    q = [r["queued"] for r in rows]
    log(f"[3] admission on {len(rows)} inputs kept from the main path "
        f"([R={N_REPLICAS}, N={a[0].shape[1]}], queued rows per input "
        f"{min(q)}-{max(q)}, mean {np.mean(q):.1f}): kernel mean "
        f"{mean['ms']:.6f} ms (min {min(kms):.6f}, median "
        f"{np.median(kms):.6f}, max {max(kms):.6f}), plain "
        f"{mean['plain_ms']:.6f} ms, chained torch.sort "
        f"{mean['library_ms']:.6f} ms, bound {bound_ms:.6f} ms (bytes "
        f"{mean['bytes_ms']:.6f}, operations {mean['ops_ms']:.6f}); equal "
        "to the plain version on every input")
    return dict(max_abs_err=err, ms=mean["ms"], plain_ms=mean["plain_ms"],
                bound_ms=bound_ms,
                bound_by=("bytes" if mean["bytes_ms"] >= mean["ops_ms"]
                          else "operations"),
                library_ms=mean["library_ms"])


# ------------------------------------------------------------ phase 3

def build_ensemble():
    """The main path's inputs, on the host: R one-day workloads with their
    compiled scenarios, padded and stacked."""
    from repro_torch.core import batching, des
    from repro_torch.core import model as M
    from repro_torch.core.workload import generate_empirical_workload
    from repro_torch.ops.capacity import MaintenanceWindows
    from repro_torch.ops.failures import FailureModel
    from repro_torch.ops.scenario import Scenario

    base = M.PlatformConfig()
    maint = MaintenanceWindows(((6 * 3600.0, 10 * 3600.0, 1, 0.5),
                                (14 * 3600.0, 16 * 3600.0, 0, 0.75)))
    plats, wls, comps, pols = [], [], [], []
    for i in range(N_REPLICAS):
        plat = base.with_capacity("learning_cluster",
                                  LEARNING_CAPS[i % len(LEARNING_CAPS)])
        pol = (des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF)[i % 3]
        wl = generate_empirical_workload(i, HORIZON_S)
        scen = Scenario(capacity=maint if i % 2 else None,
                        failures=FailureModel(resample_service=i % 4 == 3))
        plats.append(plat)
        wls.append(wl)
        pols.append(pol)
        comps.append(scen.compile(wl, plat, HORIZON_S, seed=i, policy=pol))
    cols = batching.pad_workloads(wls, plats)
    cols.update(batching.stack_scenarios(
        comps, cols["n_max"], HORIZON_S,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)]))
    caps = np.stack([p.capacities for p in plats]).astype(np.int32)
    return plats, wls, comps, np.array(pols, np.int32), cols, caps


def check_invariants(out, wls, comps):
    start = out["start"].cpu().numpy()
    finish = out["finish"].cpu().numpy()
    ready = out["ready"].cpu().numpy()
    done = out["done"].cpu().numpy()
    a_s = out["att_start"].cpu().numpy()
    a_f = out["att_finish"].cpu().numpy()
    for i, (wl, comp) in enumerate(zip(wls, comps)):
        n = wl.n
        if not done[i, :n].all():
            raise AssertionError(f"replica {i}: {int((~done[i, :n]).sum())} "
                                 "pipelines not done")
        live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
        s, f, r = start[i, :n][live], finish[i, :n][live], ready[i, :n][live]
        if np.isnan(s).any() or not ((s >= r).all() and (f >= s).all()):
            raise AssertionError(f"replica {i}: start < ready or finish < "
                                 "start, or a live task never ran")
        for res in range(comp.cap_vals.shape[1]):
            m = live & (wl.task_res == res)
            st, fi = a_s[i, :n][m].ravel(), a_f[i, :n][m].ravel()
            ran = ~np.isnan(st)
            t = np.concatenate([st[ran], fi[ran]])
            d = np.concatenate([np.ones(ran.sum()), -np.ones(ran.sum())])
            order = np.lexsort((d, t))          # a finish frees its slot first
            peak = int(np.cumsum(d[order]).max())
            cap = int(comp.cap_vals[:, res].max())
            if peak > cap:
                raise AssertionError(f"replica {i} resource {res}: {peak} "
                                     f"attempts ran at once, capacity {cap}")


def phase_main_path(torch, fused_admission, inputs):
    from repro_torch.core import batching, vdes
    plats, wls, comps, pols, cols, caps = inputs
    t = batching.to_tensors(cols, "cuda")
    n_pipes = sum(w.n for w in wls)
    log(f"[3] {N_REPLICAS} replicas x 1 day: {n_pipes} pipelines, "
        f"{sum(int(w.n_tasks.sum()) for w in wls)} tasks (seed 0: "
        f"{wls[0].n} / {int(wls[0].n_tasks.sum())}), N_max={cols['n_max']}, "
        f"T={cols['task_res'].shape[2]}, K={cols['cap_times'].shape[1]}, "
        f"attempt slots={cols['n_attempt_slots']}")
    tap = InputTap(fused_admission, KEEP_EVERY)
    vdes.fused_admission = tap
    torch.cuda.synchronize()
    fused_admission.launches = 0
    try:
        t0 = time.perf_counter()
        out = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        vdes.fused_admission = fused_admission
    launches = fused_admission.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_admission")
    waves = out["waves"].cpu().numpy()
    log(f"[3] simulate_ensemble on the card: wall {wall:.3f} s, waves max "
        f"{int(waves.max())} (min {int(waves.min())}), "
        f"{waves.max() / wall:.1f} waves/s, {n_pipes / wall:.1f} pipelines/s, "
        f"fused_admission launches {launches}")
    check_invariants(out, wls, comps)
    log("[3] invariants hold: all pipelines done, start >= ready, "
        "finish >= start, capacity never exceeded")

    idx = list(DENSE_REPLICAS)
    sub = {k: v[idx] if torch.is_tensor(v) else v for k, v in t.items()}
    t0 = time.perf_counter()
    ref = vdes.simulate_ensemble(**sub, capacities=caps[idx],
                                 policies=pols[idx], admission_sort="dense",
                                 device="cuda")
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    for k in ref:
        if not same_bits(out[k][idx], ref[k]):
            raise AssertionError(f"kernel run != dense run on replicas {idx}: "
                                 f"{k}")
    log(f"[3] replicas {idx} re-run with the plain admission on the card "
        f"({dense_wall:.3f} s): bit-identical start/finish/ready/attempts/"
        "done/waves/att_start/att_finish")
    return out, launches, wall, tap.kept


# ------------------------------------------------------------ phase 4

def phase_single(torch, fused_admission, inputs, ens):
    from repro_torch.core import trace, vdes
    from repro_torch.ops.accounting import SLOConfig
    plats, wls, comps, pols, cols, caps = inputs
    wl, plat, comp = wls[0], plats[0], comps[0]
    fused_admission.launches = 0
    t0 = time.perf_counter()
    tr = vdes.simulate_to_trace(wl, plat, int(pols[0]), scenario=comp,
                                device="cuda")
    wall = time.perf_counter() - t0
    if fused_admission.launches <= 0:
        raise AssertionError("simulate_to_trace never launched the kernel")
    n = wl.n
    for k in ("start", "finish", "ready"):
        want = ens[k][0, :n].cpu().numpy().astype(np.float64)
        if not np.array_equal(getattr(tr, k), want, equal_nan=True):
            raise AssertionError(f"simulate_to_trace != ensemble replica 0: {k}")
    rec = trace.flatten_trace(tr, wl)
    summ = trace.summarize(rec, plat.capacities, HORIZON_S,
                           schedule=comp.schedule,
                           cost_rates=np.array([0.5, 3.0]),
                           slo=SLOConfig())
    for k in ("mean_wait_s", "p95_wait_s", "total_cost",
              "deadline_miss_rate"):
        if not np.isfinite(summ[k]):
            raise AssertionError(f"summary {k} = {summ[k]}")
    if summ["n_pipelines"] != n:
        raise AssertionError("summary lost pipelines")
    log(f"[4] simulate_to_trace (wall {wall:.3f} s, {tr.waves} waves, "
        f"{fused_admission.launches} launches) == ensemble replica 0; "
        f"summary: mean_wait_s {summ['mean_wait_s']:.3f}, p95_wait_s "
        f"{summ['p95_wait_s']:.3f}, utilization "
        f"{json.dumps(summ['utilization'])}, total_cost "
        f"{summ['total_cost']:.2f}, deadline_miss_rate "
        f"{summ['deadline_miss_rate']:.4f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.queue_scan import fused_admission
    from repro_torch.kernels.ref import admission_mask_dense

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"[1] card: {card}")
    t0 = time.perf_counter()
    _build.build("fused_admission")
    log(f"[1] built fused_admission in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("fused_admission").splitlines():
        if "ptxas info" in line:
            log(f"[1]   {line.strip()}")
    t0 = time.perf_counter()
    inputs = build_ensemble()
    log(f"[1] workloads and scenarios built on the host in "
        f"{time.perf_counter() - t0:.2f} s")

    grid_err = phase_kernels(torch, fused_admission, admission_mask_dense)
    ens, launches, wall, kept = phase_main_path(torch, fused_admission,
                                                inputs)
    rec = time_admission(torch, fused_admission, admission_mask_dense, kept)
    log(f"[3] fused_admission: {launches} launches x {rec['ms']:.6f} ms = "
        f"{100 * launches * rec['ms'] / (wall * 1e3):.2f} % of the "
        "main path's wall")
    phase_single(torch, fused_admission, inputs, ens)

    kernels = [dict(
        name="fused_admission", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_admission.cu",
        replaces="src/repro/kernels/queue_scan.py:125",
        launches=launches, max_abs_err=max(grid_err, rec["max_abs_err"]),
        ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec["library_ms"])]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
