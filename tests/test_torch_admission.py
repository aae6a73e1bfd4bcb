"""The port's admission round against the reference's.

Inputs are made with numpy from a seed and handed to both packages: the
port's plain ``admission_mask_dense`` over ``[R, N]`` must equal, exactly,
the reference's Pallas ``fused_admission`` (interpret mode on the CPU) and
its ``vdes.admission_mask_dense``, replica by replica — on tie-heavy keys,
sentinel (non-queued) rows and negative or zero free slots.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vdes as ref_vdes
from repro.kernels import queue_scan as ref_qs
from repro_torch.kernels import queue_scan, ref


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, R, N, nres, sentinel_frac, float_keys=False):
    """Heavy ties in pkey and enq_wave, -0.0 beside 0.0, free in [-3, 5]."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, nres, (R, N)).astype(np.int32)
    res[rng.random((R, N)) < sentinel_frac] = nres
    if float_keys:   # SJF-like service keys with some exact repeats
        pkey = rng.choice(rng.exponential(50.0, 7), (R, N)).astype(np.float32)
    else:
        pkey = rng.integers(-2, 3, (R, N)).astype(np.float32)
        pkey[rng.random((R, N)) < 0.2] = -0.0
    wave = rng.integers(0, 4, (R, N)).astype(np.int32)
    free = rng.integers(-3, 6, (R, nres)).astype(np.int32)
    return res, pkey, wave, free


CASES = [
    # (R, N, nres, sentinel fraction, float keys)
    (1, 1, 1, 0.0, False),
    (2, 127, 2, 0.5, False),
    (3, 128, 5, 0.9, False),
    (4, 200, 2, 0.0, False),
    (2, 200, 1, 0.3, True),
]


@pytest.mark.parametrize("R,N,nres,sent,float_keys", CASES)
def test_plain_admission_matches_reference(R, N, nres, sent, float_keys):
    res, pkey, wave, free = make_case(R * 1000 + N, R, N, nres, sent,
                                      float_keys)
    got = ref.admission_mask_dense(torch.from_numpy(res),
                                   torch.from_numpy(pkey),
                                   torch.from_numpy(wave),
                                   torch.from_numpy(free)).numpy()
    assert got.shape == (R, N) and got.dtype == bool
    for r in range(R):
        args = (jnp.asarray(res[r]), jnp.asarray(pkey[r]),
                jnp.asarray(wave[r]), jnp.asarray(free[r]))
        np.testing.assert_array_equal(
            got[r], np.asarray(ref_qs.fused_admission(*args, interpret=True)))
        np.testing.assert_array_equal(
            got[r], np.asarray(ref_vdes.admission_mask_dense(*args)))


def test_plain_admission_blocks_rows_exactly(monkeypatch):
    """The row blocking of the plain version (bounded temporaries at large
    N) gives the same mask as one block."""
    res, pkey, wave, free = (torch.from_numpy(a) for a in
                             make_case(7, 3, 150, 2, 0.4))
    whole = ref.admission_mask_dense(res, pkey, wave, free)
    monkeypatch.setattr(ref, "_PAIR_BLOCK", 3 * 150 * 7)   # 7-row blocks
    np.testing.assert_array_equal(
        ref.admission_mask_dense(res, pkey, wave, free).numpy(),
        whole.numpy())


def test_wrapper_takes_plain_path_on_cpu():
    res, pkey, wave, free = (torch.from_numpy(a) for a in
                             make_case(3, 2, 64, 2, 0.5))
    before = queue_scan.fused_admission.launches
    got = queue_scan.fused_admission(res, pkey, wave, free)
    assert queue_scan.fused_admission.launches == before   # no launch
    np.testing.assert_array_equal(
        got.numpy(), ref.admission_mask_dense(res, pkey, wave, free).numpy())


def test_wrapper_rejects_malformed_inputs():
    res, pkey, wave, free = (torch.from_numpy(a) for a in
                             make_case(4, 2, 16, 2, 0.5))
    fa = queue_scan.fused_admission
    with pytest.raises(TypeError):
        fa(res, pkey.double(), wave, free)
    with pytest.raises(TypeError):
        fa(res.long(), pkey, wave, free)
    with pytest.raises(ValueError):
        fa(res, pkey[:, :8].contiguous(), wave, free)
    with pytest.raises(ValueError):
        fa(res.t().contiguous().t(), pkey, wave, free)    # not contiguous
    with pytest.raises(ValueError):
        fa(res[0], pkey[0], wave[0], free[0])             # 1-D
    with pytest.raises(ValueError):
        fa(res, pkey, wave, free[:1].contiguous())        # wrong R
    with pytest.raises(ValueError):
        fa(res[:, :0], pkey[:, :0], wave[:, :0], free)    # empty

