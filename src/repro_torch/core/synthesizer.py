"""Pipeline & data synthesizer (mirrors :mod:`repro.core.synthesizer`; paper
§IV-B): sample workloads from fitted ``SimulationParams`` — the draws and
their transforms on the device, exported to numpy ``Workload`` structures
for the engine.

Every stochastic part of a trace (structures, assets, durations, arrivals)
is drawn as a dense tensor on the generator's device. The one sequential
part is the arrival process, whose hour-of-week cluster depends on the
previous arrival. It is split in two: one vectorized pass evaluates the
interarrival transform of *every* draw under *all 168* clusters on the
device (:func:`cluster_table`), and a scalar f32 recursion on the host
picks, clips and adds in the reference's order (:func:`arrival_recursion`).
About 3,200 steps per simulated day as eager device ops would cost a launch
each; on the host they are index, clip, product and add.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core import stats
from repro_torch.core.fitting import SimulationParams
from repro_torch.core.gmm import categorical, sample_log_gmm_rejecting
from repro_torch.core.workload import MAX_TASKS

_N_CLUSTERS = 168


# ---------------------------------------------------------------------------
# Arrival sampling (§V-A.3: "map real timestamps to simulation time, and use
# that to sample from the respective cluster").
# ---------------------------------------------------------------------------

def cluster_table(clusters: stats.Dist, u: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """``[n, 168]``: draw ``i``'s interarrival under every cluster, by one
    vectorized :func:`~repro_torch.core.stats.dist_transform`."""
    return stats.dist_transform(
        clusters.family[None], clusters.p0[None], clusters.p1[None],
        clusters.p2[None], u[:, None], z[:, None])


def arrival_recursion(table: np.ndarray, interarrival_factor: float = 1.0,
                      t0: float = 0.0) -> np.ndarray:
    """The reference's scan body on the host, in f32: cluster = hour of
    week of the previous arrival, ``delta = clip(table[i, cluster], 1e-3,
    24 h) * factor``, ``t += delta``. Returns ``[n]`` f32 arrival times."""
    f32 = np.float32
    table = np.asarray(table, f32)
    lo, hi, hour = f32(1e-3), f32(24 * 3600.0), f32(3600.0)
    factor = f32(interarrival_factor)
    t = f32(t0)
    out = np.empty(table.shape[0], f32)
    for i in range(table.shape[0]):
        c = int(np.floor(t / hour)) % _N_CLUSTERS
        t = t + np.minimum(np.maximum(table[i, c], lo), hi) * factor
        out[i] = t
    return out


def sample_clustered_arrivals(clusters: stats.Dist, gen: torch.Generator,
                              n_max: int, interarrival_factor: float = 1.0,
                              t0: float = 0.0) -> np.ndarray:
    """Draw ``n_max`` arrival times; cluster = hour-of-week of the
    *previous* arrival. Returns ``[n_max]`` f32 times (monotone)."""
    u, z = stats.draw_uz(gen, (n_max,))
    table = cluster_table(clusters, u, z).cpu().numpy()
    return arrival_recursion(table, interarrival_factor, t0)


# ---------------------------------------------------------------------------
# Full workload synthesis.
# ---------------------------------------------------------------------------

def synthesize_workload(
    params: SimulationParams,
    gen: torch.Generator,
    horizon_s: float,
    platform: Optional[M.PlatformConfig] = None,
    interarrival_factor: float = 1.0,
    n_max: Optional[int] = None,
) -> M.Workload:
    """One synthetic workload over ``[0, horizon_s)``, drawn from ``gen``
    on its device (``params`` must live there)."""
    platform = platform or M.PlatformConfig()

    # --- arrivals
    mean_ia = params.interarrival_global.mean_estimate(gen, 4096) \
        * interarrival_factor
    mean_ia = max(mean_ia, 1e-2)
    if n_max is None:
        n_max = int(horizon_s / mean_ia * 1.6) + 64
    t = sample_clustered_arrivals(params.interarrival_clusters, gen, n_max,
                                  interarrival_factor)
    arrival = t[t < horizon_s].astype(np.float64)
    if arrival.shape[0] == 0:
        raise ValueError("horizon too short: no arrivals synthesized")
    return _draw_tasks(params, gen, arrival, platform)


def synthesize_block(
    params: SimulationParams,
    gen: torch.Generator,
    n: int,
    t0: float = 0.0,
    platform: Optional[M.PlatformConfig] = None,
    interarrival_factor: float = 1.0,
) -> M.Workload:
    """Synthesize exactly ``n`` pipelines continuing from clock ``t0`` (the
    streaming unit): arrivals continue the clustered interarrival process
    from ``t0``, and every per-task draw is shaped by ``n`` alone."""
    if n < 1:
        raise ValueError(f"block size must be >= 1, got {n}")
    platform = platform or M.PlatformConfig()
    arrival = sample_clustered_arrivals(
        params.interarrival_clusters, gen, n, interarrival_factor,
        t0=float(t0)).astype(np.float64)
    return _draw_tasks(params, gen, arrival, platform)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _draw_tasks(params: SimulationParams, gen: torch.Generator,
                arrival: np.ndarray, platform: M.PlatformConfig
                ) -> M.Workload:
    """Per-pipeline content draws (structures, frameworks, assets,
    durations, model assets) for a fixed arrival vector, in the
    reference's order."""
    n = arrival.shape[0]
    dev = gen.device

    # --- structures (fitted presence probabilities, canonical order)
    sp = params.structure_probs
    un = _host(torch.rand((n, M.N_TASK_TYPES), generator=gen, device=dev))
    present = un < sp[None, :]
    present[:, M.TRAIN] = True
    # deploy requires evaluate (quality gate precedes deployment)
    present[:, M.DEPLOY] &= present[:, M.EVALUATE]
    order = [M.PREPROCESS, M.TRAIN, M.EVALUATE, M.COMPRESS, M.HARDEN, M.DEPLOY]
    tt = np.full((n, MAX_TASKS), -1, np.int32)
    cnt = np.zeros(n, np.int32)
    for ttype in order:
        m = present[:, ttype]
        tt[m, cnt[m]] = ttype
        cnt[m] += 1

    # --- frameworks
    mix = torch.as_tensor(params.framework_mix, dtype=torch.float32,
                          device=dev)
    fw = _host(categorical(gen, torch.log(mix + 1e-12), n)).astype(np.int32)

    # --- assets from the log-space GMM with rejection (§V-A.1)
    assets = _host(sample_log_gmm_rejecting(
        params.asset_gmm, gen, n,
        torch.as_tensor(params.asset_lo, dtype=torch.float32, device=dev),
        torch.as_tensor(params.asset_hi, dtype=torch.float32, device=dev)))
    rows, cols, nbytes = assets[:, 0], assets[:, 1], assets[:, 2]

    # --- durations
    x = np.log(np.maximum(rows * cols, 1.0))
    noise = _host(params.preproc.noise.sample(gen, (n,)))
    t_pre = params.preproc.mean_at(x) * noise

    t_train = np.zeros(n)
    for f in range(M.N_FRAMEWORKS):
        m = fw == f
        k = int(m.sum())
        if k:
            s = params.train_loggmm[f].sample(gen, k)
            t_train[m] = np.exp(_host(s)[:, 0])
    t_eval = np.exp(_host(params.eval_loggmm.sample(gen, n))[:, 0])
    t_comp = t_train * np.clip(_host(params.compress_noise.sample(gen, (n,))), 0.05, 10.0)
    t_hard = t_train * np.clip(_host(params.harden_ratio.sample(gen, (n,))), 0.05, 50.0)
    t_depl = _host(params.deploy.sample(gen, (n,)))

    # --- model assets (materialized at train time, §V-B.b)
    perf = np.zeros(n, np.float32)
    for f in range(M.N_FRAMEWORKS):
        m = fw == f
        k = int(m.sum())
        if k:
            s = _host(params.model_perf_loggmm[f].sample(gen, k))[:, 0]
            perf[m] = 1.0 / (1.0 + np.exp(-s))
    zsz = _host(torch.randn((n,), generator=gen, device=dev))
    msize = np.exp(params.model_size_logmu[fw] + params.model_size_logsd[fw] * zsz)
    clever = np.exp(_host(torch.randn((n,), generator=gen, device=dev)) * 0.5
                    + np.log(0.3))

    per_type_time = {
        M.PREPROCESS: t_pre, M.TRAIN: t_train, M.EVALUATE: t_eval,
        M.COMPRESS: t_comp, M.HARDEN: t_hard, M.DEPLOY: t_depl,
    }
    exec_time = np.zeros((n, MAX_TASKS))
    read_b = np.zeros((n, MAX_TASKS))
    write_b = np.zeros((n, MAX_TASKS))
    for j in range(MAX_TASKS):
        col = tt[:, j]
        for ttype, tv in per_type_time.items():
            m = col == ttype
            if not m.any():
                continue
            exec_time[m, j] = np.maximum(tv[m], 1e-2)
            if ttype == M.PREPROCESS:
                read_b[m, j] = nbytes[m]; write_b[m, j] = nbytes[m]
            elif ttype == M.TRAIN:
                read_b[m, j] = nbytes[m]; write_b[m, j] = msize[m]
            elif ttype == M.EVALUATE:
                read_b[m, j] = msize[m] + 0.2 * nbytes[m]
            elif ttype == M.COMPRESS:
                read_b[m, j] = msize[m]; write_b[m, j] = 0.4 * msize[m]
            elif ttype == M.HARDEN:
                read_b[m, j] = msize[m] + nbytes[m]; write_b[m, j] = msize[m]
            elif ttype == M.DEPLOY:
                read_b[m, j] = msize[m]

    task_res = platform.route(np.maximum(tt, 0)) * (tt >= 0)
    wl = M.Workload(
        arrival=arrival, n_tasks=cnt, task_type=tt,
        task_res=task_res.astype(np.int32),
        exec_time=exec_time, read_bytes=read_b, write_bytes=write_b,
        framework=fw, priority=np.zeros(n, np.float32),
        model_perf=perf, model_size=msize.astype(np.float32),
        model_clever=clever.astype(np.float32),
    )
    wl.asset_rows = rows   # type: ignore[attr-defined]
    wl.asset_cols = cols   # type: ignore[attr-defined]
    wl.asset_bytes = nbytes  # type: ignore[attr-defined]
    return wl
