"""The port's synthesizer (``repro_torch.core.synthesizer``) against the JAX
package's, on the CPU, from the committed fitted parameters
(``artifacts/pipesim_params.npz``, loaded by both packages).

- The arrival recursion, fed the reference's own ``(u, z)`` draws, equals
  ``sample_clustered_arrivals`` to rtol 1e-6 (both run the same f32
  recursion; the transform table differs from XLA's by a few ulps).
- ``synthesize_workload`` over 2 days (fixed seeds, so deterministic)
  agrees with the reference's in distribution: pipeline count within 5 %,
  each task type's presence rate within 0.03, each task type's median
  duration within 20 % (types with at least 200 tasks on both sides;
  about 400 harden tasks give a median's sampling error near 10 %), the
  framework mix within 0.03, and every asset inside the fitted rejection
  bounds in both.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import fitting as ref_fitting
from repro.core import synthesizer as ref_synth
from repro_torch.core import fitting, synthesizer
from repro_torch.core import model as M

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts" / \
    "pipesim_params.npz"
HORIZON = 2 * 86400.0


@pytest.fixture(scope="module")
def params():
    return (ref_fitting.SimulationParams.load(str(ARTIFACT)),
            fitting.SimulationParams.load(str(ARTIFACT), device="cpu"))


@pytest.mark.parametrize("factor,t0", [(1.0, 0.0), (1.7, 5000.0)])
def test_arrival_recursion_on_reference_draws(params, factor, t0):
    ref, port = params
    key = jax.random.PRNGKey(11)
    n = 3000
    want = np.asarray(ref_synth.sample_clustered_arrivals(
        ref.interarrival_clusters, key, n, factor, t0=t0))
    u = np.array(jax.random.uniform(key, (n,), minval=1e-7,
                                    maxval=1.0 - 1e-7))
    z = np.array(jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    table = synthesizer.cluster_table(port.interarrival_clusters,
                                      torch.from_numpy(u),
                                      torch.from_numpy(z)).numpy()
    assert table.shape == (n, 168)
    got = synthesizer.arrival_recursion(table, factor, t0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _stats(w):
    live = np.arange(w.max_tasks)[None, :] < w.n_tasks[:, None]
    rate, med, cnt = {}, {}, {}
    for t in range(M.N_TASK_TYPES):
        m = (w.task_type == t) & live
        rate[t] = m.any(1).mean()
        cnt[t] = int(m.sum())
        med[t] = float(np.median(w.exec_time[m])) if cnt[t] else np.nan
    return rate, med, cnt


@pytest.fixture(scope="module")
def workloads(params):
    ref, port = params
    return (ref_synth.synthesize_workload(ref, jax.random.PRNGKey(0), HORIZON),
            synthesizer.synthesize_workload(
                port, torch.Generator().manual_seed(0), HORIZON))


def test_synthesize_workload_matches_reference_in_distribution(params,
                                                               workloads):
    ref_p, port_p = params
    rw, pw = workloads
    pw.validate()
    assert (np.diff(pw.arrival) >= 0).all() and pw.arrival.max() < HORIZON
    assert pw.n == pytest.approx(rw.n, rel=0.05)
    (rr, rm, rc), (pr, pm, pc) = _stats(rw), _stats(pw)
    for t in range(M.N_TASK_TYPES):
        assert pr[t] == pytest.approx(rr[t], abs=0.03), t
        if min(rc[t], pc[t]) >= 200:
            assert pm[t] == pytest.approx(rm[t], rel=0.2), t
    mix = [np.bincount(w.framework, minlength=M.N_FRAMEWORKS) / w.n
           for w in (rw, pw)]
    assert np.abs(mix[0] - mix[1]).max() < 0.03
    lo, hi = port_p.asset_lo, port_p.asset_hi
    for w in (rw, pw):
        a = np.stack([w.asset_rows, w.asset_cols, w.asset_bytes], 1)
        assert (a >= lo.astype(np.float32) * (1 - 1e-6)).all()
        assert (a <= hi.astype(np.float32) * (1 + 1e-6)).all()


def test_synthesize_block_continues_the_clock(params):
    _, port = params
    gen = torch.Generator().manual_seed(3)
    a = synthesizer.synthesize_block(port, gen, 40)
    b = synthesizer.synthesize_block(port, gen, 25, t0=float(a.arrival[-1]))
    assert (a.n, b.n) == (40, 25)
    assert b.arrival[0] > a.arrival[-1]
    for w in (a, b):
        w.validate()
        assert (np.diff(w.arrival) > 0).all()
