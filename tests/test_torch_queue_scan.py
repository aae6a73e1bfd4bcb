"""The port's ``queue_scan`` against the reference's, on the CPU.

Ready and service times are made with numpy from a seed and handed to both
packages. The function is comparisons and one f32 add per job, so the
port's public wrapper (on CPU tensors, the plain version) equals the
reference's Pallas kernel (interpret mode) and its jnp version bit for bit;
against the f64 numpy oracle it is held to 1e-2, the reference test's
tolerance (f32 times of a few hundred carry about 3e-5 of rounding per
add). A numpy emulation of the CUDA kernel's sorted-slot step (test-only,
not a kernel) is held bit for bit against both plain versions on every
route the kernel has.
"""
import jax
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
from repro_torch.kernels import queue_scan as qs


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


def sorted_slot_scan(rdy, svc, c, S, G):
    """numpy f32 emulation of ``csrc/queue_scan.cu`` on route ``(S, G)``:
    each row's slots sorted ascending, zeros for the c real ones and +inf
    padding to the width S * G, split over G "lanes" of S. Per job the
    minimum is the group's first slot; then every slot k takes
    ``max(a[k], min(a[k+1], finish))`` (no max at the group's slot 0), a
    lane's last slot taking its a[k+1] from the next lane's first slot
    (+inf past the last lane)."""
    R, N = rdy.shape
    x = np.full((R, G * S), np.inf, np.float32)
    x[:, :c] = 0.0
    x = x.reshape(R, G, S)
    inf = np.full((R, 1), np.inf, np.float32)
    start = np.empty((R, N), np.float32)
    finish = np.empty((R, N), np.float32)
    for j in range(N):
        s = np.maximum(rdy[:, j], x[:, 0, 0])
        f = s + svc[:, j]
        nx = np.concatenate([x[:, 1:, 0], inf], axis=1)         # [R, G]
        hi = np.concatenate([x[:, :, 1:], nx[:, :, None]], axis=2)
        lo = x.copy()
        lo[:, 0, 0] = -np.inf
        x = np.maximum(lo, np.minimum(hi, f[:, None, None]))
        start[:, j], finish[:, j] = s, f
    return start, finish


def queue_inputs(kind, c, seed):
    """``ties``: ready times from a few distinct integers, services in
    {0, 1, 2, 3}; ``exponential``: Poisson arrivals at a load near 1,
    exponential services; ``short``: N < c jobs."""
    rng = np.random.default_rng(seed)
    R, N = 6, (c - 1 if kind == "short" else 160)
    if kind == "ties":
        rdy = np.sort(rng.choice(np.arange(0, N, 7), (R, N)), axis=1)
        svc = rng.integers(0, 4, (R, N)) * (1 + c // 8)
    else:
        rdy = np.cumsum(rng.exponential(1.0, (R, N)), axis=1)
        svc = rng.exponential(0.9 * c, (R, N))
    return rdy.astype(np.float32), svc.astype(np.float32)


_jax_queue_ref = jax.jit(jref.queue_scan_ref, static_argnames="capacity")
SWEEP_CAPS = (1, 2, 7, 8, 9, 16, 17, 32, 33, 64, 65, 128, 256)


@pytest.mark.parametrize("kind,c", [
    (kind, c) for kind in ("ties", "exponential", "short")
    for c in SWEEP_CAPS if not (kind == "short" and c == 1)])
def test_sorted_slot_step_equals_plain_bit_for_bit(kind, c):
    """The kernel's step, emulated on every route that holds c, equals the
    port's and the reference's plain versions bit for bit."""
    rdy, svc = queue_inputs(kind, c, 1000 + c)
    assert rdy.shape[1] < c or kind != "short"
    want = ref.queue_scan_ref(torch.from_numpy(rdy), torch.from_numpy(svc),
                              capacity=c)
    jwant = _jax_queue_ref(jnp.asarray(rdy), jnp.asarray(svc), capacity=c)
    for a, b in zip(want, jwant):
        same_bits(a, b)
    routes = [r for r in qs.ROUTES if r[0] * r[1] >= c]
    assert routes
    for S, G in routes:
        got = sorted_slot_scan(rdy, svc, c, S, G)
        for g, w in zip(got, want):
            same_bits(torch.from_numpy(g), w.numpy())
    if kind == "ties":
        assert (svc == 0).any() and len(np.unique(rdy)) < rdy.size // 4

