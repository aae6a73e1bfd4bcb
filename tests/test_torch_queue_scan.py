"""The port's ``queue_scan`` against the reference's, on the CPU.

Ready and service times are made with numpy from a seed and handed to both
packages. The function is comparisons and one f32 add per job, so the
port's public wrapper (on CPU tensors, the plain version) equals the
reference's Pallas kernel (interpret mode) and its jnp version bit for bit;
against the f64 numpy oracle it is held to 1e-2, the reference test's
tolerance (f32 times of a few hundred carry about 3e-5 of rounding per
add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import des as jdes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import des
from repro_torch.kernels import ops, ref


def jobs(seed, R, N):
    rng = np.random.default_rng(seed)
    rdy = np.sort(rng.uniform(0, 500, (R, N)), axis=1).astype(np.float32)
    svc = rng.exponential(5.0, (R, N)).astype(np.float32)
    return rdy, svc


def same_bits(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("c", [1, 2, 7])
def test_plain_equals_reference_bit_for_bit(c):
    rdy, svc = jobs(c, 4, 250)
    st_, fi_ = ops.queue_scan(torch.from_numpy(rdy), torch.from_numpy(svc),
                              capacity=c)
    for want in (jops.queue_scan(jnp.asarray(rdy), jnp.asarray(svc),
                                 capacity=c, interpret=True),
                 jref.queue_scan_ref(jnp.asarray(rdy), jnp.asarray(svc),
                                     capacity=c)):
        same_bits(st_, want[0])
        same_bits(fi_, want[1])
    # the port's own plain version is what the wrapper ran
    for got, want in zip(ref.queue_scan_ref(torch.from_numpy(rdy),
                                            torch.from_numpy(svc), capacity=c),
                         (st_, fi_)):
        same_bits(got, want.numpy())


@pytest.mark.parametrize("c", [1, 2, 7])
def test_matches_f64_oracle(c):
    rdy, svc = jobs(10 + c, 4, 250)
    st_, fi_ = ops.queue_scan(torch.from_numpy(rdy), torch.from_numpy(svc),
                              capacity=c)
    for r in range(rdy.shape[0]):
        st_np, fi_np = des.single_station_fifo(rdy[r], svc[r], c)
        # the port's oracle is a copy of the reference's
        for a, b in zip((st_np, fi_np),
                        jdes.single_station_fifo(rdy[r], svc[r], c)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(st_.numpy()[r], st_np, atol=1e-2)
        np.testing.assert_allclose(fi_.numpy()[r], fi_np, atol=1e-2)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10**6), c=st.integers(1, 5),
       n=st.integers(1, 60))
def test_properties(seed, c, n):
    """``tests/test_kernels.py``'s properties, for any workload: starts >=
    ready; finish = start + service; at most c jobs in service at once;
    FIFO start order."""
    r = np.random.default_rng(seed)
    rdy = np.sort(r.uniform(0, 50, n)).astype(np.float32)
    svc = (r.exponential(3.0, n) + 0.01).astype(np.float32)
    st_, fi_ = ops.queue_scan(torch.from_numpy(rdy[None]),
                              torch.from_numpy(svc[None]), capacity=c)
    st_, fi_ = st_.numpy()[0], fi_.numpy()[0]
    assert (st_ >= rdy - 1e-4).all()
    np.testing.assert_allclose(fi_, st_ + svc, atol=1e-4)
    assert (np.diff(st_) >= -1e-4).all()
    events = sorted([(s, 1) for s in st_] + [(f, -1) for f in fi_],
                    key=lambda e: (e[0], e[1]))
    load = peak = 0
    for _, delta in events:
        load += delta
        peak = max(peak, load)
    assert peak <= c


def test_casts_to_f32_and_refuses_bad_arguments():
    rdy, svc = jobs(3, 2, 20)
    st64, _ = ops.queue_scan(torch.from_numpy(rdy.astype(np.float64)),
                             torch.from_numpy(svc.astype(np.float64)),
                             capacity=2)
    st32, _ = ops.queue_scan(torch.from_numpy(rdy), torch.from_numpy(svc),
                             capacity=2)
    same_bits(st64, st32.numpy())
    r, s = torch.from_numpy(rdy), torch.from_numpy(svc)
    with pytest.raises(ValueError, match="capacity"):
        ops.queue_scan(r, s, capacity=0)
    with pytest.raises(ValueError, match="shape"):
        ops.queue_scan(r, s[:, :-1], capacity=1)
    with pytest.raises(ValueError, match=r"\[R, N\]"):
        ops.queue_scan(r[0], s[0], capacity=1)
    with pytest.raises(TypeError, match="float"):
        ops.queue_scan(r.int(), s, capacity=1)
