"""The port on the card: each kernel against its plain version, and the
engine through the kernel against the engine through the plain version.

These tests need a CUDA device and ``nvcc`` and skip elsewhere. They
import the port only (no JAX, no reference), so they also run where the
reference is not installed. On the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest releases JAX caches after each
module and so needs JAX.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batching, des, vdes, workload
from repro_torch.core import model as M
from repro_torch.kernels import queue_scan, ref
from repro_torch.ops.capacity import MaintenanceWindows
from repro_torch.ops.failures import FailureModel
from repro_torch.ops.scenario import Scenario


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def make_case(seed, R, N, nres, sentinel_frac, float_keys):
    rng = np.random.default_rng(seed)
    res = rng.integers(0, nres, (R, N)).astype(np.int32)
    res[rng.random((R, N)) < sentinel_frac] = nres
    if float_keys:
        pkey = rng.choice(rng.exponential(50.0, 7), (R, N)).astype(np.float32)
    else:
        pkey = rng.integers(-2, 3, (R, N)).astype(np.float32)
        pkey[rng.random((R, N)) < 0.2] = -0.0
    wave = rng.integers(0, 4, (R, N)).astype(np.int32)
    free = rng.integers(-3, max(6, N // nres), (R, nres)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (res, pkey, wave, free)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,nres,sent,float_keys", [
    (1, 1, 1, 0.0, False), (2, 127, 2, 0.5, False), (3, 128, 5, 0.9, False),
    (4, 300, 2, 0.0, True), (32, 2500, 2, 0.8, True),
    (2, 5000, 5, 0.0, False)])
def test_kernel_matches_plain_on_card(R, N, nres, sent, float_keys):
    """Exactly equal, and one launch counted per call."""
    _need_card()
    args = make_case(N, R, N, nres, sent, float_keys)
    before = queue_scan.fused_admission.launches
    got = queue_scan.fused_admission(*args)
    torch.cuda.synchronize()
    assert queue_scan.fused_admission.launches == before + 1
    assert torch.equal(got, ref.admission_mask_dense(*args))


@pytest.mark.cuda
def test_kernel_engine_equals_dense_on_card():
    """The engine through the CUDA kernel equals the engine through the
    plain version on the card, bit for bit, and launched the kernel."""
    _need_card()
    horizon = 0.1 * 86400.0
    plats = [M.PlatformConfig().with_capacity(1, c) for c in (4, 8, 16)]
    wls = [workload.generate_empirical_workload(s, horizon) for s in range(3)]
    comps = [Scenario(capacity=MaintenanceWindows(((3600.0, 5400.0, 1, 0.5),)),
                      failures=FailureModel(resample_service=s == 2)).compile(
                          wl, p, horizon, seed=s)
             for s, (wl, p) in enumerate(zip(wls, plats))]
    cols = batching.pad_workloads(wls, plats)
    cols.update(batching.stack_scenarios(
        comps, cols["n_max"], horizon,
        services=[w.service_time(p.datastore) for w, p in zip(wls, plats)]))
    t = batching.to_tensors(cols, "cuda")
    caps = np.stack([p.capacities for p in plats])
    pols = np.array([des.POLICY_FIFO, des.POLICY_PRIORITY, des.POLICY_SJF])
    before = queue_scan.fused_admission.launches
    a = vdes.simulate_ensemble(**t, capacities=caps, policies=pols)
    assert queue_scan.fused_admission.launches > before
    b = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                               admission_sort="dense")
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k
    assert a["done"][0, :wls[0].n].all()
