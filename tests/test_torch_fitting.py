"""The port's fit (``repro_torch.core.fitting``) against the JAX package's,
on the CPU, and the ``.npz`` layout both packages share.

Both packages fit the same 2-day ground truth (seed 7) once per module,
with ``asset_components=8, em_iters=10, max_cluster_fit_n=400`` to keep the
reference's compile time down.

- Fields that use no random draw are equal: the preprocess curve and its
  noise, the compress/harden/deploy fits, the framework mix, the structure
  probabilities, the model-size moments, the global interarrival fit and
  the asset bounds.
- Interarrival clusters agree as ``best_fit`` does
  (``tests/test_torch_stats.py``): where the families differ, the port's
  family scores within 20 % of the reference's choice by the reference's
  own SSE; where they agree, the parameters are equal.
- Every GMM's mean log-likelihood on its data lies within 0.1 nats of the
  reference GMM's: EM from different k-means++ draws lands in different
  local optima (the largest gap on this data is about 0.05 nats).
- The ``.npz`` round trip reference -> port -> reference is exact, and
  the port loads the committed ``artifacts/pipesim_params.npz``.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fitting as ref_fitting
from repro.core import stats as ref_stats
from repro.core import workload as ref_workload
from repro_torch.core import fitting, workload
from repro_torch.core import model as M

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "artifacts" / "pipesim_params.npz"
FIT_KW = dict(asset_components=8, em_iters=10, max_cluster_fit_n=400)
LL_MARGIN = 0.1
SSE_MARGIN = 0.2


@pytest.fixture(scope="module")
def fits():
    ref_wl = ref_workload.generate_empirical_workload(seed=7,
                                                      horizon_s=2 * 86400.0)
    wl = workload.generate_empirical_workload(seed=7, horizon_s=2 * 86400.0)
    ref = ref_fitting.fit_simulation_params(ref_wl, **FIT_KW)
    port = fitting.fit_simulation_params(wl, device="cpu", **FIT_KW)
    return wl, ref, port


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def _dist_eq(pd, rd):
    return all(_eq(getattr(pd, f).numpy(), getattr(rd, f))
               for f in ("family", "p0", "p1", "p2"))


def test_deterministic_fields_equal(fits):
    _, ref, port = fits
    for f in ("a", "b", "c"):
        assert getattr(port.preproc, f) == getattr(ref.preproc, f)
    assert _dist_eq(port.preproc.noise, ref.preproc.noise)
    for f in ("compress_noise", "harden_ratio", "deploy",
              "interarrival_global"):
        assert _dist_eq(getattr(port, f), getattr(ref, f)), f
    for f in ("framework_mix", "structure_probs", "model_size_logmu",
              "model_size_logsd", "asset_lo", "asset_hi"):
        assert _eq(getattr(port, f), getattr(ref, f)), f


def _cluster_data(wl, cidx, max_n):
    """The interarrivals the fit gives cluster ``cidx`` (as the fit cuts
    them)."""
    t_arr = np.sort(np.asarray(wl.arrival))
    ia = np.maximum(np.diff(t_arr), 1e-3)
    d = ia[fitting.cluster_of_time(t_arr[:-1]) == cidx]
    if d.size > max_n:
        d = d[np.linspace(0, d.size - 1, max_n).astype(int)]
    return d


def test_clusters_agree_as_best_fit(fits):
    wl, ref, port = fits
    rc, pc = ref.interarrival_clusters, port.interarrival_clusters
    fam_r, fam_p = np.asarray(rc.family), pc.family.numpy()
    assert fam_r.shape == fam_p.shape == (168,)
    assert (fam_r == fam_p).mean() > 0.9
    for c in range(168):
        if fam_r[c] == fam_p[c]:
            for f in ("p0", "p1", "p2"):
                assert getattr(pc, f)[c].item() == float(getattr(rc, f)[c]), c
            continue
        d = _cluster_data(wl, c, FIT_KW["max_cluster_fit_n"])
        sse = {int(f): ref_stats.histogram_sse(d, ref_stats._FITTERS[int(f)](d))
               for f in (fam_r[c], fam_p[c])}
        assert sse[int(fam_p[c])] * (1 - SSE_MARGIN) <= sse[int(fam_r[c])], c


def gmm_data(wl):
    """Each GMM's training data, as the fit builds it."""
    out = {"asset_gmm": fitting.asset_matrix(wl)}
    tr = fitting._task_durations(wl, M.TRAIN)
    fw_tr = fitting._pipeline_value_for_task(wl, M.TRAIN, wl.framework)
    ev = fitting._task_durations(wl, M.EVALUATE)
    out["eval_gmm"] = np.log(np.maximum(ev, 1e-3))[:, None]
    for f in range(M.N_FRAMEWORKS):
        d = tr[fw_tr == f]
        out[f"train_gmm_{f}"] = np.log(d if d.shape[0] >= 8 else tr)[:, None]
        p = wl.model_perf[wl.framework == f]
        p = np.clip(p if p.shape[0] >= 8 else wl.model_perf, 1e-4, 1 - 1e-4)
        out[f"perf_gmm_{f}"] = np.log(p / np.maximum(1.0 - p, 1e-6))[:, None]
    return out


def test_gmm_likelihoods_within_margin(fits):
    wl, ref, port = fits
    ref_gmms = {"asset_gmm": ref.asset_gmm, "eval_gmm": ref.eval_loggmm}
    for f in range(M.N_FRAMEWORKS):
        ref_gmms[f"train_gmm_{f}"] = ref.train_loggmm[f]
        ref_gmms[f"perf_gmm_{f}"] = ref.model_perf_loggmm[f]
    data = gmm_data(wl)
    gmms = port.gmms()
    assert set(gmms) == set(ref_gmms) and len(gmms) == 12
    for k, g in gmms.items():
        assert g.n_components == ref_gmms[k].means.shape[0], k
        x = data[k].astype(np.float32)
        got = float(g.log_prob(torch.from_numpy(x)).mean())
        want = float(jnp.mean(ref_gmms[k].log_prob(jnp.asarray(x))))
        assert abs(got - want) <= LL_MARGIN, (k, got, want)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_npz_round_trip_between_packages(fits, tmp_path):
    """reference save -> port load -> port save -> reference load: the
    same 67 arrays, key for key, dtype for dtype, bit for bit."""
    _, ref, _ = fits
    a, b = tmp_path / "ref.npz", tmp_path / "port.npz"
    ref.save(str(a))
    fitting.SimulationParams.load(str(a), device="cpu").save(str(b))
    za, zb = _npz(a), _npz(b)
    assert len(za) == 67 and set(za) == set(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and _eq(za[k], zb[k]), k
    back = ref_fitting.SimulationParams.load(str(b))
    assert _eq(back.asset_gmm.chol, ref.asset_gmm.chol)
    assert _eq(back.interarrival_clusters.p2, ref.interarrival_clusters.p2)


def test_port_save_load_round_trip(fits, tmp_path):
    _, _, port = fits
    p = tmp_path / "p.npz"
    port.save(str(p))
    back = fitting.SimulationParams.load(str(p), device="cpu")
    for k, g in port.gmms().items():
        assert torch.equal(back.gmms()[k].chol, g.chol), k
    for f in ("family", "p0", "p1", "p2"):
        assert torch.equal(getattr(back.interarrival_clusters, f),
                           getattr(port.interarrival_clusters, f)), f


def test_port_loads_committed_artifact():
    z = _npz(ARTIFACT)
    assert len(z) == 67
    p = fitting.SimulationParams.load(str(ARTIFACT), device="cpu")
    assert p.asset_gmm.means.shape == z["asset_gmm.1"].shape
    assert p.interarrival_clusters.family.shape == (168,)
    assert len(p.gmms()) == 12
    for k, g in p.gmms().items():
        assert torch.isfinite(g.chol).all(), k
        assert _eq(g.log_weights.numpy(), z[f"{k}.0"]), k
