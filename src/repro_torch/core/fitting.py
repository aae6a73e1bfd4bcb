"""Fit-and-export: empirical traces -> SimulationParams (mirrors
:mod:`repro.core.fitting`; paper §V-A).

"We run queries on this database and fit different statistical distributions
on the extracted data … The generated models or distribution parameters are
exported using Python's serialization to the simulator."

The 'database' is a :class:`repro_torch.core.model.Workload` from the
ground-truth generator (or platform telemetry). The twelve GMMs of the fit
run their EM on the device (every E-step through the ``gmm_logpdf``
kernel); the curve fit, the moment fits and the 168 interarrival-cluster
fits stay on the host in numpy/scipy, as in the reference. Everything
fitted is collected in :class:`SimulationParams`, which reads and writes
the reference's ``.npz`` layout key for key, so a file written by either
package loads into the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core import stats
from repro_torch.core.gmm import GMM, fit_gmm
from repro_torch.core.model import Workload
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PreprocCurve:
    """t_exec = (a * b**x + c) * noise,  x = ln(rows*cols) (Fig 9a)."""

    a: float
    b: float
    c: float
    noise: stats.Dist  # multiplicative residual distribution

    def mean_at(self, x: np.ndarray) -> np.ndarray:
        return self.a * np.power(self.b, np.clip(x, 0.0, 26.0)) + self.c


# the reference's pytree leaf order: the .npz keys are "<prefix>.<i>"
_GMM_LEAVES = ("log_weights", "means", "chol")
_DIST_LEAVES = ("family", "p0", "p1", "p2")


@dataclasses.dataclass
class SimulationParams:
    """Everything the simulator samples from, exported from fits. The
    tensors of the GMMs and Dists live on one device (:meth:`to`)."""

    asset_gmm: GMM                       # on log(rows, cols, bytes)
    asset_lo: np.ndarray                 # [3] rejection bounds (linear space)
    asset_hi: np.ndarray
    preproc: PreprocCurve
    train_loggmm: Dict[int, GMM]         # per framework, 1-D on log seconds
    eval_loggmm: GMM
    compress_noise: stats.Dist           # ratio vs train duration (normal)
    harden_ratio: stats.Dist             # lognormal ratio vs train duration
    deploy: stats.Dist
    framework_mix: np.ndarray            # [F]
    structure_probs: np.ndarray          # [6] presence prob per task type
    interarrival_global: stats.Dist
    interarrival_clusters: stats.Dist    # batched [168]
    model_perf_loggmm: Dict[int, GMM]    # per framework, on logit(perf)
    model_size_logmu: np.ndarray         # [F] lognormal params for bytes
    model_size_logsd: np.ndarray

    def to(self, device) -> "SimulationParams":
        """A copy with every GMM and Dist on ``device``."""
        def mv(v):
            if isinstance(v, (GMM, stats.Dist)):
                return v.to(device)
            if isinstance(v, PreprocCurve):
                return dataclasses.replace(v, noise=v.noise.to(device))
            if isinstance(v, dict):
                return {k: mv(g) for k, g in v.items()}
            return v
        return SimulationParams(**{f.name: mv(getattr(self, f.name))
                                   for f in dataclasses.fields(self)})

    # ------------------------------------------------------------------ io
    def save(self, path: str) -> None:
        """Write the reference's ``.npz`` layout, key for key and dtype for
        dtype."""
        flat = {}

        def put(prefix, obj, leaves):
            for i, name in enumerate(leaves):
                flat[f"{prefix}.{i}"] = getattr(obj, name).cpu().numpy()

        def gmm(prefix, g):
            put(prefix, g, _GMM_LEAVES)

        def dist(prefix, d):
            put(prefix, d, _DIST_LEAVES)

        gmm("asset_gmm", self.asset_gmm)
        flat["asset_lo"], flat["asset_hi"] = self.asset_lo, self.asset_hi
        flat["preproc_abc"] = np.array([self.preproc.a, self.preproc.b,
                                        self.preproc.c])
        dist("preproc_noise", self.preproc.noise)
        for f, g in self.train_loggmm.items():
            gmm(f"train_gmm_{f}", g)
        gmm("eval_gmm", self.eval_loggmm)
        dist("compress_noise", self.compress_noise)
        dist("harden_ratio", self.harden_ratio)
        dist("deploy", self.deploy)
        flat["framework_mix"] = self.framework_mix
        flat["structure_probs"] = self.structure_probs
        dist("ia_global", self.interarrival_global)
        dist("ia_clusters", self.interarrival_clusters)
        for f, g in self.model_perf_loggmm.items():
            gmm(f"perf_gmm_{f}", g)
        flat["msize_mu"] = self.model_size_logmu
        flat["msize_sd"] = self.model_size_logsd
        np.savez_compressed(path, **flat)

    @staticmethod
    def load(path: str, device=None) -> "SimulationParams":
        """Read an ``.npz`` written by either package onto ``device``
        (``None``: the card)."""
        dev = resolve_device(device)
        with np.load(path) as z:
            def t(key):
                return torch.as_tensor(z[key], device=dev)

            def dist(prefix):
                return stats.Dist(*[t(f"{prefix}.{i}") for i in range(4)])

            def gmm(prefix):
                return GMM(*[t(f"{prefix}.{i}") for i in range(3)])

            a, b, c = z["preproc_abc"]
            return SimulationParams(
                asset_gmm=gmm("asset_gmm"),
                asset_lo=z["asset_lo"], asset_hi=z["asset_hi"],
                preproc=PreprocCurve(float(a), float(b), float(c),
                                     dist("preproc_noise")),
                train_loggmm={f: gmm(f"train_gmm_{f}")
                              for f in range(M.N_FRAMEWORKS)},
                eval_loggmm=gmm("eval_gmm"),
                compress_noise=dist("compress_noise"),
                harden_ratio=dist("harden_ratio"),
                deploy=dist("deploy"),
                framework_mix=z["framework_mix"],
                structure_probs=z["structure_probs"],
                interarrival_global=dist("ia_global"),
                interarrival_clusters=dist("ia_clusters"),
                model_perf_loggmm={f: gmm(f"perf_gmm_{f}")
                                   for f in range(M.N_FRAMEWORKS)},
                model_size_logmu=z["msize_mu"],
                model_size_logsd=z["msize_sd"],
            )

    def gmms(self) -> Dict[str, GMM]:
        """Every fitted GMM by its ``.npz`` prefix (the 12 of a fit)."""
        out = {"asset_gmm": self.asset_gmm, "eval_gmm": self.eval_loggmm}
        out.update({f"train_gmm_{f}": g for f, g in self.train_loggmm.items()})
        out.update({f"perf_gmm_{f}": g
                    for f, g in self.model_perf_loggmm.items()})
        return out


# ---------------------------------------------------------------------------
# dataset extraction helpers
# ---------------------------------------------------------------------------

def _task_durations(wl: Workload, ttype: int) -> np.ndarray:
    live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
    m = (wl.task_type == ttype) & live
    return wl.exec_time[m]


def _pipeline_value_for_task(wl: Workload, ttype: int, values: np.ndarray) -> np.ndarray:
    live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
    m = (wl.task_type == ttype) & live
    rows = np.nonzero(m.any(axis=1))[0]
    return values[rows]


def cluster_of_time(t_seconds: np.ndarray) -> np.ndarray:
    """hour-of-week cluster index (0..167), Monday 00:00 == 0."""
    return (np.asarray(t_seconds) // 3600.0).astype(np.int64) % 168


def asset_matrix(wl: Workload) -> np.ndarray:
    """``[n, 3]`` log(rows, cols, bytes) of the assets the asset GMM is fit
    on: the paper's filter drops the unlikely-training assets with fewer
    than 50 rows or 2 columns (§V-A.1)."""
    rows = np.asarray(getattr(wl, "asset_rows"))
    cols = np.asarray(getattr(wl, "asset_cols"))
    byts = np.asarray(getattr(wl, "asset_bytes"))
    keep = (rows >= 50) & (cols >= 2)
    return np.log(np.stack([rows[keep], cols[keep], byts[keep]], 1))


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

def fit_simulation_params(
    wl: Workload,
    gen: Optional[torch.Generator] = None,
    asset_components: int = 50,
    duration_components: int = 6,
    em_iters: int = 50,
    interarrival_families: Sequence[int] = (
        stats.LOGNORMAL, stats.EXPONWEIB, stats.PARETO),
    max_cluster_fit_n: int = 4000,
    device=None,
) -> SimulationParams:
    """The reference's fit with its defaults. The GMMs' EM runs on
    ``device`` (``None``: the card), drawing its k-means++ inits from
    ``gen`` (default: a generator on that device seeded 0), in the
    reference's order; everything else runs on the host. The result lives
    on ``device``."""
    dev = resolve_device(device)
    gen = gen if gen is not None else torch.Generator(dev).manual_seed(0)

    def gmm(x: np.ndarray, k: int, n_iter: int) -> GMM:
        return fit_gmm(gen, torch.as_tensor(x, dtype=torch.float32,
                                             device=dev), k, n_iter)

    # -- assets: GMM(K=50, full cov) on log(rows, cols, bytes)
    rows = np.asarray(getattr(wl, "asset_rows"))
    cols = np.asarray(getattr(wl, "asset_cols"))
    X = asset_matrix(wl)
    n_comp = min(asset_components, max(2, X.shape[0] // 20))
    asset_gmm = gmm(X, n_comp, em_iters)
    lin = np.exp(X)
    asset_lo = np.array([50.0, 2.0, np.quantile(lin[:, 2], 0.001)])
    asset_hi = np.quantile(lin, 0.9995, axis=0) * 4.0

    # -- preprocess curve: nonlinear least squares of a*b**x + c on
    #    x = ln(rows*cols) (Fig 9a), lognormal fit on multiplicative residual.
    pp_t = _task_durations(wl, M.PREPROCESS)
    pp_x = np.log(np.maximum(
        _pipeline_value_for_task(wl, M.PREPROCESS, rows)
        * _pipeline_value_for_task(wl, M.PREPROCESS, cols), 1.0))
    from scipy.optimize import curve_fit

    def f(x, a, b, c):
        return a * np.power(b, np.clip(x, 0.0, 26.0)) + c

    try:
        (a, b, c), _ = curve_fit(
            f, pp_x, pp_t, p0=[0.02, 1.3, 2.0],
            bounds=([1e-6, 1.01, 0.0], [10.0, 2.0, 60.0]), maxfev=20000)
    except Exception:
        a, b, c = 0.018, 1.330, 2.156  # paper's published fallback
    resid = pp_t / np.maximum(f(pp_x, a, b, c), 1e-6)
    preproc = PreprocCurve(float(a), float(b), float(c),
                           stats.fit_lognormal(resid))

    # -- train durations: stratify by framework, 1-D GMM on log seconds.
    train_gmms: Dict[int, GMM] = {}
    tr_all = _task_durations(wl, M.TRAIN)
    fw_tr = _pipeline_value_for_task(wl, M.TRAIN, wl.framework)
    for fw in range(M.N_FRAMEWORKS):
        d = tr_all[fw_tr == fw]
        if d.shape[0] < 8:
            d = tr_all  # tiny stratum: fall back to pooled data
        kcomp = min(duration_components, max(1, d.shape[0] // 10))
        train_gmms[fw] = gmm(np.log(d)[:, None], kcomp, em_iters)

    # -- evaluate durations: raw-compute-time GMM (§V-A.2c).
    ev = _task_durations(wl, M.EVALUATE)
    eval_gmm = gmm(np.log(np.maximum(ev, 1e-3))[:, None],
                   min(duration_components, max(1, ev.shape[0] // 10)),
                   em_iters)

    # -- compress: ratio to the pipeline's train duration + Gaussian (§V-A.2d)
    def _ratio_to_train(ttype):
        live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
        has = ((wl.task_type == ttype) & live).any(1)
        rows_i = np.nonzero(has)[0]
        tsel = []
        rsel = []
        for i in rows_i:
            tts = wl.task_type[i, : wl.n_tasks[i]]
            tr_j = np.nonzero(tts == M.TRAIN)[0]
            c_j = np.nonzero(tts == ttype)[0]
            if len(tr_j) and len(c_j):
                tsel.append(wl.exec_time[i, c_j[0]])
                rsel.append(wl.exec_time[i, tr_j[0]])
        t = np.asarray(tsel)
        r = np.maximum(np.asarray(rsel), 1e-6)
        return t / r

    cr = _ratio_to_train(M.COMPRESS)
    compress_noise = stats.fit_normal(cr if cr.size >= 8 else np.array([1.0, 1.1]))
    hr = _ratio_to_train(M.HARDEN)
    harden_ratio = stats.fit_lognormal(hr if hr.size >= 8 else np.array([2.0, 3.0]))
    dp = _task_durations(wl, M.DEPLOY)
    deploy = stats.fit_lognormal(dp if dp.size >= 8 else np.array([10.0, 20.0]))

    # -- structure + framework frequencies
    fmix = np.bincount(wl.framework, minlength=M.N_FRAMEWORKS).astype(np.float64)
    fmix /= fmix.sum()
    live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
    sprobs = np.array([
        ((wl.task_type == t) & live).any(1).mean() for t in range(M.N_TASK_TYPES)])

    # -- interarrivals: global exp-Weibull + 168 hour-of-week clusters with
    #    best-of-{lognormal, exp-Weibull, Pareto} by SSE (§V-A.3).
    t_arr = np.sort(np.asarray(wl.arrival))
    ia = np.diff(t_arr)
    ia = np.maximum(ia, 1e-3)
    sub = ia[np.linspace(0, ia.size - 1, min(ia.size, max_cluster_fit_n * 4)).astype(int)]
    try:
        ia_global = stats.fit_exponweib(sub)
    except Exception:
        ia_global = stats.fit_lognormal(sub)
    clus = cluster_of_time(t_arr[:-1])
    cluster_dists = []
    for cidx in range(168):
        d = ia[clus == cidx]
        if d.size < 25:
            cluster_dists.append(ia_global)
            continue
        if d.size > max_cluster_fit_n:
            d = d[np.linspace(0, d.size - 1, max_cluster_fit_n).astype(int)]
        cluster_dists.append(stats.best_fit(d, interarrival_families))
    ia_clusters = stats.stack_dists(cluster_dists)

    # -- model metrics per framework
    perf_gmms: Dict[int, GMM] = {}
    logit = lambda p: np.log(p / np.maximum(1.0 - p, 1e-6))
    for fw in range(M.N_FRAMEWORKS):
        p = wl.model_perf[wl.framework == fw]
        if p.shape[0] < 8:
            p = wl.model_perf
        perf_gmms[fw] = gmm(logit(np.clip(p, 1e-4, 1 - 1e-4))[:, None], 3, 40)
    msz_mu = np.zeros(M.N_FRAMEWORKS)
    msz_sd = np.zeros(M.N_FRAMEWORKS)
    for fw in range(M.N_FRAMEWORKS):
        s = wl.model_size[wl.framework == fw]
        if s.shape[0] < 4:
            s = wl.model_size
        msz_mu[fw] = np.log(s).mean()
        msz_sd[fw] = np.log(s).std() + 1e-6

    return SimulationParams(
        asset_gmm=asset_gmm, asset_lo=asset_lo, asset_hi=asset_hi,
        preproc=preproc, train_loggmm=train_gmms, eval_loggmm=eval_gmm,
        compress_noise=compress_noise, harden_ratio=harden_ratio, deploy=deploy,
        framework_mix=fmix, structure_probs=sprobs,
        interarrival_global=ia_global, interarrival_clusters=ia_clusters,
        model_perf_loggmm=perf_gmms,
        model_size_logmu=msz_mu, model_size_logsd=msz_sd,
    ).to(dev)
