"""Ground-truth workload generator — the "real system" being traced.

Numpy-only copy of :mod:`repro.core.workload` for the PyTorch port: the
same seed gives the same workload, bit for bit.

IBM's analytics database is proprietary, so (exactly like the paper separates
the platform from the simulator) we implement the *platform side* as a
generative process parameterized with every constant the paper publishes:

  - framework mix 63/32/3/1/1 (SparkML/TF/PyTorch/Caffe/other), §IV-B.1;
  - preprocess compute time curve f(x) = 0.018 * 1.330**x + 2.156 over
    x = ln(rows*cols), Fig 9(a);
  - per-framework duration scales (50% of TF jobs < 180 s, 50% of SparkML
    < 10 s), Fig 9(b);
  - compression time ~ training time + Gaussian noise (§V-A.2d) and the
    Table I pruning effects;
  - mean interarrival 44 s with hour-of-week modulation (Fig 10): weekday
    peaks at 10:00 and 15:00-16:00, night troughs, ~40% weekend load.

The generator deliberately uses *different* noise families (gamma
multiplicative, two-component lognormal mixtures, Weibull renewal bursts)
than the simulator's fitted families (lognormal additive, GMMs,
exp-Weibull/Pareto), so the Fig 12 Q-Q agreement is an earned test of the
fit-export-sample machinery rather than a tautology.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import model as M

# ---------------------------------------------------------------------------
# Hour-of-week arrival-rate profile (Fig 10 shape).
# ---------------------------------------------------------------------------

def hour_of_week_weights() -> np.ndarray:
    """[168] relative arrival rates, Monday 00:00 first. Weekday double peak
    (10:00, 15:00-16:00), lunch dip, low nights; weekends damped."""
    hours = np.arange(24)
    day = (
        0.25
        + 0.9 * np.exp(-0.5 * ((hours - 10.0) / 2.0) ** 2)
        + 1.0 * np.exp(-0.5 * ((hours - 15.5) / 2.2) ** 2)
        - 0.18 * np.exp(-0.5 * ((hours - 12.5) / 0.9) ** 2)
    )
    week = []
    for dow in range(7):
        scale = 1.0 if dow < 5 else 0.38
        jitter = 1.0 + 0.05 * np.cos(dow)  # mild day-to-day variation
        week.append(day * scale * jitter)
    w = np.concatenate(week)
    return w / w.mean()


MEAN_INTERARRIVAL_S = 44.0  # paper §VI-C


def generate_arrivals(rng: np.random.Generator, horizon_s: float,
                      interarrival_factor: float = 1.0,
                      burst_shape: float = 0.7) -> np.ndarray:
    """Nonhomogeneous bursty renewal arrivals via operational-time warping.

    Gaps are Weibull(k=burst_shape) (bursty, non-exponential — the reason the
    paper's exp-Weibull fits win) in operational time, warped through the
    piecewise-linear cumulative hour-of-week rate.
    ``interarrival_factor`` scales mean interarrival (paper's experiment knob).
    """
    w = hour_of_week_weights()
    mean_gap = MEAN_INTERARRIVAL_S * interarrival_factor
    rate_per_hour = 3600.0 / mean_gap * w            # arrivals per hour-slot
    n_hours = int(np.ceil(horizon_s / 3600.0))
    slot_rate = rate_per_hour[np.arange(n_hours) % 168]
    cum = np.concatenate([[0.0], np.cumsum(slot_rate)])  # Lambda at hour edges
    total = cum[-1] * min(1.0, horizon_s / (n_hours * 3600.0) + 1.0)

    k = burst_shape
    from math import gamma as _g
    wb_mean = _g(1.0 + 1.0 / k)
    n_draw = int(total * 1.25 + 100)
    gaps = rng.weibull(k, n_draw) / wb_mean           # mean-1 operational gaps
    u = np.cumsum(gaps)
    u = u[u < cum[-1]]
    # invert piecewise-linear Lambda
    hr = np.searchsorted(cum, u, side="right") - 1
    hr = np.clip(hr, 0, n_hours - 1)
    frac = (u - cum[hr]) / np.maximum(cum[hr + 1] - cum[hr], 1e-9)
    t = (hr + frac) * 3600.0
    return t[t < horizon_s]


# ---------------------------------------------------------------------------
# Assets: archetype mixture producing the Fig 8 cluster + linear structure.
# ---------------------------------------------------------------------------

_ARCHETYPES = [
    # (log-rows mu, sigma), (log-cols mu, sigma), weight
    ((np.log(5e2), 0.9), (np.log(12), 0.5), 0.30),    # small tabular
    ((np.log(5e4), 1.0), (np.log(30), 0.6), 0.35),    # medium tabular
    ((np.log(2e6), 0.8), (np.log(20), 0.7), 0.20),    # tall telemetry
    ((np.log(1e4), 0.7), (np.log(900), 0.5), 0.10),   # wide/feature-expanded
    ((np.log(3e5), 1.2), (np.log(3000), 0.4), 0.05),  # image-embedding like
]


def generate_assets(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 3] (rows, cols, bytes)."""
    ws = np.array([a[2] for a in _ARCHETYPES])
    comp = rng.choice(len(_ARCHETYPES), size=n, p=ws / ws.sum())
    mu_r = np.array([a[0][0] for a in _ARCHETYPES])[comp]
    sd_r = np.array([a[0][1] for a in _ARCHETYPES])[comp]
    mu_c = np.array([a[1][0] for a in _ARCHETYPES])[comp]
    sd_c = np.array([a[1][1] for a in _ARCHETYPES])[comp]
    rows = np.exp(rng.normal(mu_r, sd_r))
    cols = np.exp(rng.normal(mu_c, sd_c))
    rows = np.maximum(rows, 50.0)
    cols = np.maximum(cols, 2.0)
    # bytes ~ rows*cols*cell_bytes with lognormal spread (Fig 8 right panel)
    cell = np.exp(rng.normal(np.log(6.0), 0.55, size=n))
    bytes_ = rows * cols * cell
    return np.stack([rows, cols, bytes_], axis=1)


# ---------------------------------------------------------------------------
# Task durations (ground truth).
# ---------------------------------------------------------------------------

PREPROC_A, PREPROC_B, PREPROC_C = 0.018, 1.330, 2.156  # Fig 9(a) fit

# per-framework (log-median, sigma) pairs for the two lognormal modes and the
# mixing weight of the fast mode. Medians honor Fig 9(b).
_TRAIN_GT = {
    M.SPARKML: ((np.log(6.0), 0.7), (np.log(45.0), 0.9), 0.62),
    M.TENSORFLOW: ((np.log(60.0), 0.8), (np.log(700.0), 1.0), 0.45),
    M.PYTORCH: ((np.log(120.0), 0.9), (np.log(1500.0), 0.8), 0.50),
    M.CAFFE: ((np.log(300.0), 0.7), (np.log(3000.0), 0.9), 0.45),
    M.OTHERFW: ((np.log(20.0), 1.2), (np.log(400.0), 1.2), 0.60),
}


def gt_preprocess_time(rng: np.random.Generator, rows, cols) -> np.ndarray:
    x = np.log(np.maximum(rows * cols, 1.0))
    base = PREPROC_A * PREPROC_B ** np.clip(x, 0.0, 26.0) + PREPROC_C
    noise = rng.gamma(4.0, 0.25, size=np.shape(x))  # mean-1 multiplicative
    return base * noise


def gt_train_time(rng: np.random.Generator, framework: np.ndarray) -> np.ndarray:
    out = np.empty(framework.shape, np.float64)
    for fw, ((m1, s1), (m2, s2), w) in _TRAIN_GT.items():
        m = framework == fw
        k = int(m.sum())
        if k == 0:
            continue
        pick = rng.random(k) < w
        d = np.where(pick, rng.lognormal(m1, s1, k), rng.lognormal(m2, s2, k))
        out[m] = d
    return out


def gt_evaluate_time(rng: np.random.Generator, n: int) -> np.ndarray:
    heavy = rng.random(n) < 0.05
    base = rng.lognormal(np.log(20.0), 0.8, n)
    tail = rng.lognormal(np.log(600.0), 1.0, n)
    return np.where(heavy, tail, base)


def gt_compress_time(rng: np.random.Generator, train_time: np.ndarray) -> np.ndarray:
    # §V-A.2d: "roughly as much time as training" + Gaussian noise
    return np.maximum(train_time * rng.normal(1.0, 0.15, train_time.shape), 1.0)


def gt_harden_time(rng: np.random.Generator, train_time: np.ndarray) -> np.ndarray:
    return np.maximum(train_time * rng.normal(2.5, 0.5, train_time.shape), 2.0)


def gt_deploy_time(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.lognormal(np.log(15.0), 0.5, n)


# model assets (materialized at train time, §V-B.b)
_PERF_BETA = {  # (alpha, beta) of Beta-distributed model performance
    M.SPARKML: (9.0, 3.0),
    M.TENSORFLOW: (12.0, 3.0),
    M.PYTORCH: (11.0, 3.0),
    M.CAFFE: (10.0, 4.0),
    M.OTHERFW: (6.0, 3.0),
}
_MODEL_MB = {  # log-median model size in MB
    M.SPARKML: np.log(2.0),
    M.TENSORFLOW: np.log(90.0),
    M.PYTORCH: np.log(150.0),
    M.CAFFE: np.log(60.0),
    M.OTHERFW: np.log(10.0),
}


def gt_model_metrics(rng: np.random.Generator, framework: np.ndarray):
    n = framework.shape[0]
    perf = np.empty(n)
    size = np.empty(n)
    for fw in range(M.N_FRAMEWORKS):
        m = framework == fw
        k = int(m.sum())
        if not k:
            continue
        a, b = _PERF_BETA[fw]
        perf[m] = rng.beta(a, b, k)
        size[m] = rng.lognormal(_MODEL_MB[fw], 0.8, k) * 1e6
    clever = rng.lognormal(np.log(0.3), 0.5, n)
    return perf.astype(np.float32), size.astype(np.float32), clever.astype(np.float32)


# ---------------------------------------------------------------------------
# Pipeline structure (Fig 1 prototypes with optional-step probabilities).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StructureProbs:
    p_preprocess: float = 0.70
    p_evaluate: float = 0.88
    p_compress: float = 0.15
    p_harden: float = 0.08
    p_deploy: float = 0.78   # conditional on evaluate present

MAX_TASKS = 6


def generate_structures(rng: np.random.Generator, n: int,
                        probs: "StructureProbs | None" = None):
    """[n, MAX_TASKS] ordered task types (-1 padded) + [n] lengths.
    Order is always  preprocess? -> train -> evaluate? -> compress? ->
    harden? -> deploy?  which keeps synthetic pipelines 'sensible' (§IV-B.1:
    a validation task cannot precede training)."""
    probs = probs if probs is not None else StructureProbs()
    tt = np.full((n, MAX_TASKS), -1, np.int64)
    cnt = np.zeros(n, np.int64)

    def push(mask, ttype):
        nonlocal tt, cnt
        tt[mask, cnt[mask]] = ttype
        cnt[mask] += 1

    push(rng.random(n) < probs.p_preprocess, M.PREPROCESS)
    push(np.ones(n, bool), M.TRAIN)
    has_eval = rng.random(n) < probs.p_evaluate
    push(has_eval, M.EVALUATE)
    push(rng.random(n) < probs.p_compress, M.COMPRESS)
    push(rng.random(n) < probs.p_harden, M.HARDEN)
    push(has_eval & (rng.random(n) < probs.p_deploy), M.DEPLOY)
    return tt, cnt


def whole_seconds(wl: M.Workload, datastore: M.DataStoreConfig) -> M.Workload:
    """The same workload with every time a whole number of seconds:
    arrivals rounded up, each task's execution time set to its service
    time (execution plus data-store I/O) rounded up, and no I/O bytes, so
    the service time is that whole number. Whole seconds are exact in f32
    and f64, where the port's engine and the reference's agree bit for
    bit."""
    live = wl.task_type >= 0
    none = np.zeros_like(wl.read_bytes)
    return dataclasses.replace(
        wl, arrival=np.ceil(wl.arrival),
        exec_time=np.where(live, np.ceil(wl.service_time(datastore)), 0.0),
        read_bytes=none, write_bytes=none.copy())


# ---------------------------------------------------------------------------
# Full empirical workload.
# ---------------------------------------------------------------------------

def generate_empirical_workload(
    seed: int,
    horizon_s: float,
    interarrival_factor: float = 1.0,
    platform: M.PlatformConfig | None = None,
    structure: StructureProbs | None = None,
) -> M.Workload:
    # instance defaults are constructed per call: a shared default instance
    # would alias state across calls (see the TriggerRule fix in runtime.py)
    structure = structure if structure is not None else StructureProbs()
    platform = platform or M.PlatformConfig()
    rng = np.random.default_rng(seed)
    arrival = generate_arrivals(rng, horizon_s, interarrival_factor)
    n = arrival.shape[0]
    tt, cnt = generate_structures(rng, n, structure)
    assets = generate_assets(rng, n)
    rows, cols, nbytes = assets[:, 0], assets[:, 1], assets[:, 2]
    framework = rng.choice(M.N_FRAMEWORKS, size=n, p=M.FRAMEWORK_MIX)

    exec_time = np.zeros((n, MAX_TASKS))
    read_b = np.zeros((n, MAX_TASKS))
    write_b = np.zeros((n, MAX_TASKS))
    train_t = gt_train_time(rng, framework)
    perf, msize, clever = gt_model_metrics(rng, framework)

    for j in range(MAX_TASKS):
        col_t = tt[:, j]
        for ttype in range(M.N_TASK_TYPES):
            m = col_t == ttype
            k = int(m.sum())
            if not k:
                continue
            if ttype == M.PREPROCESS:
                exec_time[m, j] = gt_preprocess_time(rng, rows[m], cols[m])
                read_b[m, j] = nbytes[m]
                write_b[m, j] = nbytes[m] * rng.lognormal(0.0, 0.2, k)
            elif ttype == M.TRAIN:
                exec_time[m, j] = train_t[m]
                read_b[m, j] = nbytes[m]
                write_b[m, j] = msize[m]
            elif ttype == M.EVALUATE:
                exec_time[m, j] = gt_evaluate_time(rng, k)
                read_b[m, j] = msize[m] + 0.2 * nbytes[m]
            elif ttype == M.COMPRESS:
                exec_time[m, j] = gt_compress_time(rng, train_t[m])
                read_b[m, j] = msize[m]
                write_b[m, j] = msize[m] * 0.4
            elif ttype == M.HARDEN:
                exec_time[m, j] = gt_harden_time(rng, train_t[m])
                read_b[m, j] = msize[m] + nbytes[m]
                write_b[m, j] = msize[m]
            elif ttype == M.DEPLOY:
                exec_time[m, j] = gt_deploy_time(rng, k)
                read_b[m, j] = msize[m]

    task_res = platform.route(np.maximum(tt, 0)) * (tt >= 0)
    wl = M.Workload(
        arrival=arrival,
        n_tasks=cnt.astype(np.int32),
        task_type=tt.astype(np.int32),
        task_res=task_res.astype(np.int32),
        exec_time=exec_time,
        read_bytes=read_b,
        write_bytes=write_b,
        framework=framework.astype(np.int32),
        priority=np.zeros(n, np.float32),
        model_perf=perf,
        model_size=msize,
        model_clever=clever,
    )
    # attach asset features for the fitting layer
    wl.asset_rows = rows  # type: ignore[attr-defined]
    wl.asset_cols = cols  # type: ignore[attr-defined]
    wl.asset_bytes = nbytes  # type: ignore[attr-defined]
    return wl
