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



# ------------------------------------------------ the sort-based rankings

def ranking_case(seed, R, N, nres, specials=True, nan=False):
    """``make_case``'s keys with ±inf (and NaN) among the policy keys."""
    res, pkey, wave, free = make_case(seed, R, N, nres, 0.3)
    rng = np.random.default_rng(seed + 1)
    if specials:
        pkey[rng.random((R, N)) < 0.1] = np.inf
        pkey[rng.random((R, N)) < 0.1] = -np.inf
    if nan:
        pkey[rng.random((R, N)) < 0.1] = np.nan
        pkey[rng.random((R, N)) < 0.05] = -np.nan
    wave = rng.integers(0, 1 << 20, (R, N)).astype(np.int32)
    wave[rng.random((R, N)) < 0.5] = 3                     # ties
    return res, pkey, wave, free


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("R,N,nres", [(1, 1, 1), (3, 130, 2), (2, 257, 5)])
def test_rankings_equal_reference_orders(R, N, nres, nan):
    """``admission_order`` and ``admission_order_chained`` give the
    reference's sorted resources and permutations exactly, row by row
    (ties broken by id, -0.0 with +0.0, NaN last as JAX's comparator)."""
    from repro_torch.core import vdes
    res, pkey, wave, free = ranking_case(N + nres, R, N, nres, nan=nan)
    args = [torch.from_numpy(a) for a in (res, pkey, wave)]
    fused = vdes.admission_order(*args, nres)
    chained = vdes.admission_order_chained(*args)
    for r in range(R):
        jargs = [jnp.asarray(a[r]) for a in (res, pkey, wave)]
        for got, want in ((fused, ref_vdes.admission_order(*jargs)),
                          (chained, ref_vdes.admission_order_chained(*jargs))):
            np.testing.assert_array_equal(got[0][r].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1][r].numpy(),
                                          np.asarray(want[1]))


@pytest.mark.parametrize("R,N,nres,sent,float_keys", CASES)
def test_ranked_masks_equal_plain_and_reference(R, N, nres, sent,
                                                float_keys):
    """The seat test over either ranking equals the plain pairwise mask
    and the reference's kernel, with ±inf among the keys."""
    from repro_torch.core import vdes
    res, pkey, wave, free = make_case(R * 7 + N, R, N, nres, sent,
                                      float_keys)
    rng = np.random.default_rng(N)
    pkey[rng.random((R, N)) < 0.1] = np.inf
    pkey[rng.random((R, N)) < 0.1] = -np.inf
    args = [torch.from_numpy(a) for a in (res, pkey, wave, free)]
    want = ref.admission_mask_dense(*args).numpy()
    for rank in (vdes.admission_order, vdes.admission_order_chained):
        got = vdes.admission_mask_ranked(rank, *args)
        assert got.dtype == torch.bool and tuple(got.shape) == (R, N)
        np.testing.assert_array_equal(got.numpy(), want)
    for r in range(R):
        jargs = [jnp.asarray(a[r]) for a in (res, pkey, wave, free)]
        np.testing.assert_array_equal(
            want[r], np.asarray(ref_qs.fused_admission(*jargs,
                                                       interpret=True)))


def test_fused_ranking_is_one_sort_and_refuses_overflow():
    """One ``aten.sort`` per fused ranking (three for the chained); a
    resource count that leaves the key no bits for the wave is refused
    with ``ValueError`` naming the widths."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import vdes

    class Sorts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten.sort:
                Sorts.n += 1
            return func(*args, **(kwargs or {}))

    res, pkey, wave, free = (torch.from_numpy(a) for a in
                             ranking_case(9, 2, 64, 3))
    for rank, n in ((vdes.admission_order, 1),
                    (vdes.admission_order_chained, 3)):
        Sorts.n = 0
        with Sorts():
            vdes.admission_mask_ranked(rank, res, pkey, wave, free)
        assert Sorts.n == n
    assert vdes.fused_key_widths(3) == (2, 29)
    with pytest.raises(ValueError, match="resource bits"):
        vdes.admission_order(res, pkey, wave, 2 ** 31)


@pytest.fixture(scope="module")
def oracle_runs():
    """``chip_smoke.py`` phase 13's ensemble (whole-second times, integer
    priorities, mixed policies, retries and drains) through the engine
    under each admission mode, and the reference's numpy engine per
    replica."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro.core import des as ref_des
    from repro.core import model as RM
    from repro.ops.capacity import CapacitySchedule as RefSchedule
    from repro.ops.scenario import CompiledScenario as RefCompiled
    from repro_torch.core import batching, vdes
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cols, caps, pols, wls, comps, plat = cs.oracle_ensemble()
    runs = {mode: vdes.simulate_ensemble(**batching.to_tensors(cols, "cpu"),
                                         capacities=caps, policies=pols,
                                         admission_sort=mode, device="cpu")
            for mode in vdes.ADMISSION_SORTS}
    ref_plat = RM.PlatformConfig().with_capacity(
        "learning_cluster", cs.ORACLE_LEARNING_CAP)
    K = cols["cap_times"].shape[1]
    traces = []
    for i, (wl, c) in enumerate(zip(wls, comps)):
        sched = c.schedule.padded(K, cs.ORACLE_HORIZON_S)
        scen = RefCompiled(schedule=RefSchedule(sched.times, sched.caps),
                           attempts=c.attempts, backoff=c.backoff,
                           attempt_service=c.attempt_service,
                           fail_holds_frac=c.fail_holds_frac)
        rwl = RM.Workload(**{f.name: getattr(wl, f.name)
                             for f in dataclasses.fields(wl)})
        traces.append((wl, ref_des.simulate(rwl, ref_plat, int(pols[i]),
                                            scenario=scen)))
    return runs, traces


@pytest.mark.parametrize("mode", ["kernel", "dense", "fused", "chained"])
def test_engine_per_admission_mode_equals_numpy_engine(oracle_runs, mode):
    """Every output key equal bit for bit to the plain mode's, and
    start/finish/ready, attempts and completion to ``des.simulate``'s,
    replica by replica."""
    runs, traces = oracle_runs
    out = runs[mode]
    for k, want in runs["dense"].items():
        assert torch.equal(out[k].nan_to_num(-7.0), want.nan_to_num(-7.0)), k
    for i, (wl, tr) in enumerate(traces):
        n = wl.n
        live = np.arange(wl.max_tasks)[None, :] < wl.n_tasks[:, None]
        for k in ("start", "finish", "ready"):
            got = out[k][i, :n].numpy().astype(np.float64)
            np.testing.assert_array_equal(got[live], getattr(tr, k)[live],
                                          err_msg=f"replica {i} {k}")
        np.testing.assert_array_equal(out["attempts"][i, :n].numpy()[live],
                                      tr.attempts[live])
        np.testing.assert_array_equal(out["done"][i, :n].numpy(),
                                      tr.completed)
