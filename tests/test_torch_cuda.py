"""The port on the card: each kernel against its plain version, the
engine through the kernel against the engine through the plain version,
the serving path through the flash kernel against the plain path, the EM
through the GMM kernel with no host sync per iteration, the hybrid's
forward through the SSD kernel against its plain path, the card's
engine against the port's CPU path on ``chip_smoke.py`` phase 13's and
phase 14(b)'s ensembles (the latter with every stage of the wave loop), and
the segment-restart hooks, the compaction driver and the streaming driver
on the card against one call, the one-shot run and the CPU path, every
kernel refusing autograd, and a crash-restart training run resuming bit for
bit.

These tests need a CUDA device and ``nvcc`` and skip elsewhere. They
import the port only (no JAX, no reference), so they also run where the
reference is not installed. On the card:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest releases JAX caches after each
module and so needs JAX.)
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import batching, des, gmm, vdes, workload
from repro_torch.core import model as M
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm_logpdf as gl
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import queue_scan, ref
from repro_torch.models.transformer import get_model
from repro_torch.ops.capacity import MaintenanceWindows
from repro_torch.ops.failures import FailureModel
from repro_torch.ops.scenario import Scenario

# the bit-for-bit training twin runs cuBLAS deterministically, which needs
# this set before the process's first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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
    (2, 5000, 5, 0.0, False), (1, 17000, 5, 0.0, False),
    (2, 6000, 2, 0.3, True)])
def test_kernel_matches_plain_on_card(R, N, nres, sent, float_keys):
    """Exactly equal, and one launch counted per call; among the inputs,
    every row queued at N = 17,000, and replicas whose ~4,200 queued rows
    span three of the kernel's shared tiles (2,048 entries each)."""
    _need_card()
    args = make_case(N, R, N, nres, sent, float_keys)
    before = queue_scan.fused_admission.launches
    got = queue_scan.fused_admission(*args)
    torch.cuda.synchronize()
    assert queue_scan.fused_admission.launches == before + 1
    assert torch.equal(got, ref.admission_mask_dense(*args))


@pytest.mark.cuda
def test_kernel_with_one_queued_row_on_card():
    """One queued row in a 32 x 2,673 input (the wave loop's width): every
    other chunk exits at once; the mask equals the plain version's and
    admits exactly that row."""
    _need_card()
    res, pkey, wave, free = make_case(0, 32, 2673, 2, 1.0, True)
    res[16, 1336] = 1
    free[16, 1] = 1
    got = queue_scan.fused_admission(res, pkey, wave, free)
    assert torch.equal(got, ref.admission_mask_dense(res, pkey, wave, free))
    assert int(got.sum()) == 1


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


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_engine_card_equals_cpu_oracle_chain():
    """``chip_smoke.py`` phase 13: a whole-second ensemble with retries,
    backoff, partial-progress failures, resampled attempts and drains below
    the busy count, on the card (kernel admission) and through the CPU path,
    equal bit for bit on every output key, after checking that every
    replica retried. ``tests/test_torch_engine_oracle.py`` holds the CPU
    path bit for bit against the reference's numpy engine on the same
    ensemble."""
    _need_card()
    counts = (queue_scan.fused_admission, fa.flash_attention,
              gl.gmm_logpdf, ms.mamba2_scan, queue_scan.queue_scan)
    n_keys, waves, launched = _chip_smoke().engine_card_vs_cpu(torch, counts)
    assert n_keys == 8 and waves > 0
    assert launched["fused_admission"] > 0

@pytest.mark.cuda
def test_fullstack_card_equals_cpu_oracle_chain():
    """``chip_smoke.py`` phase 14(b): every stage of the wave loop on
    (controller, reliability, fleet, probe, with padding rows on one
    replica), on the card and through the CPU path, equal bit for bit on
    every output key after checking that the stages acted and that one
    model's three redeploys share a wave.
    ``tests/test_torch_engine_oracle.py`` holds that CPU path against the
    reference's numpy engine."""
    _need_card()
    cs = _chip_smoke()
    counts = (queue_scan.fused_admission, fa.flash_attention,
              gl.gmm_logpdf, ms.mamba2_scan, queue_scan.queue_scan)
    n_keys, waves, launched, per = cs.fullstack_card_vs_cpu(torch, counts)
    assert n_keys == len(cs.FSO_KEYS) and waves > 0
    assert launched["fused_admission"] > 0
    assert per[cs.FSO_BURST]["redeploys"] == 3


@pytest.mark.cuda
def test_slot_order_gain_sum_on_card():
    """The redeploy-burst replica alone on the card: its three same-model
    gains, whose f32 sum depends on the order of the adds, give the CPU
    path's performance timeline bit for bit (the CPU path adds them in slot
    order, as the reference's numpy engine does)."""
    _need_card()
    cs = _chip_smoke()
    cols, caps, pols = cs.fullstack_oracle_ensemble()[:3]
    i = cs.FSO_BURST
    one = {k: (v[i:i + 1] if isinstance(v, np.ndarray) else v)
           for k, v in cols.items()}
    run = {dev: vdes.simulate_ensemble(
        **batching.to_tensors(one, dev), capacities=caps[i:i + 1],
        policies=pols[i:i + 1], device=dev) for dev in ("cuda", "cpu")}
    for k in ("fleet_perf", "fleet_stale", "fleet_act", "fleet_n",
              "start", "finish", "waves"):
        assert cs.same_bits(run["cuda"][k].cpu(), run["cpu"][k]), k
    acts = run["cpu"]["fleet_act"][0][:int(run["cpu"]["fleet_n"][0])]
    assert int((acts[:, 1] == des.FLEET_ACT_REDEPLOY).sum()) == 3


def _counts():
    return (queue_scan.fused_admission, fa.flash_attention, gl.gmm_logpdf,
            ms.mamba2_scan, queue_scan.queue_scan)


@pytest.mark.cuda
def test_hooks_cut_and_resume_on_card():
    """Phase 13's oracle ensemble on the card, cut every few waves
    (replicas staggered) and resumed from the returned state: equal to
    one call on every output key."""
    _need_card()
    cols, caps, pols = _chip_smoke().oracle_ensemble()[:3]
    t = batching.to_tensors(cols, "cuda")

    def run(**hooks):
        return vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                      device="cuda", **hooks)

    whole = run()
    st = run(wave_budget=np.zeros(len(pols), np.int32),
             return_state=True)["state"]
    stagger = torch.arange(len(pols), dtype=torch.int32, device="cuda") + 50
    while True:
        got = run(resume=st, wave_budget=st["wave"] + stagger,
                  return_state=True)
        st = got["state"]
        if not bool(got["running"].any()):
            break
    for k in whole:
        assert _chip_smoke().same_bits(got[k], whole[k]), k


@pytest.mark.cuda
def test_compacted_equals_uncompacted_on_card():
    """``simulate_ensemble_compacted`` on phase 13's oracle ensemble on the
    card (kernel admission) equals the one call bit for bit; only the
    admission kernel launched."""
    _need_card()
    cs = _chip_smoke()
    cols, caps, pols = cs.oracle_ensemble()[:3]
    out, log, _, launches, n_keys = cs.compacted_vs_uncompacted(
        torch, _counts(), cols, caps, pols)
    assert n_keys == 8 and launches > 0
    assert log.n_compactions > 1 and log.distinct_shapes > 1


@pytest.mark.cuda
def test_stream_equals_oneshot_and_cpu_on_card():
    """``chip_smoke.py`` phase 15(c): phase 13's replica 0 streamed from a
    pinned source on the card equals its one-shot run (drift 0.0) and the
    CPU path's stream bit for bit, which the CPU twins hold against the
    reference."""
    _need_card()
    n, waves, launched = _chip_smoke().stream_card_vs_cpu(torch, _counts())
    assert n > 10 and waves > 0 and launched["fused_admission"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 1, 4, 4, 64), (2, 200, 4, 2, 64), (4, 1024, 32, 8, 64),
    (1, 256, 8, 1, 128), (2, 130, 4, 4, 128), (2, 4096, 32, 32, 64),
    (1, 129, 4, 2, 64), (1, 129, 4, 2, 128), (2, 200, 8, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(B, S, H, Hkv, D, dtype, causal):
    """Within tests/test_kernels.py's tolerances (1e-5 f32, 2e-2 bf16) on
    the largest difference, in bf16 also within 1e-2 on each output row's
    ||diff|| / ||want|| (the largest difference sits in the early causal
    rows, where |o| is largest; the row-relative one also sees the late
    key tiles, and one bf16 step is 0.4-0.8 % of a value), and one launch
    counted per call; among the shapes, the hybrid forward's and ragged
    lengths whose last key tile TMA fills with zeros past S."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + H + D)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda").to(dtype)
               for h in (H, Hkv, Hkv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    diff = got.float() - want.float()
    assert float(diff.abs().max()) <= tol
    if dtype == torch.bfloat16:
        row_rel = diff.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(row_rel.max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_f32_stays_on_cuda_cores(D):
    """f32 inputs take the f32 kernel: within 1e-5 of the plain version,
    which no path that rounds q, k, v or p to bf16 or TF32 can reach (the
    same function on bf16-rounded inputs is shown to miss by far more)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(D)
    q, k, v = (torch.randn(2, 300, h, D, generator=g, device="cuda")
               for h in (8, 2, 2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == torch.float32
    want = ref.flash_attention_ref(q, k, v)
    assert float((got - want).abs().max()) <= 1e-5
    rounded = ref.flash_attention_ref(*(t.bfloat16().float()
                                        for t in (q, k, v)))
    assert float((rounded - want).abs().max()) > 1e-3


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take():
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    _need_card()
    for D in (72, 144):     # not a multiple of 16; above 128
        q = torch.randn(1, 8, 2, D, device="cuda")
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
def test_serving_flash_matches_plain_on_card():
    """The smoke model at head dim 64 in f32: prefill through the kernel
    (one launch per layer) equals the plain path's within 1e-4."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for impl in ("flash", "xla"):
        cfg = configs.get_smoke_config("llama3.2-1b", head_dim=64,
                                       attn_impl=impl)
        model = get_model(cfg)
        params = model.init(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 100), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))
        before = fa.flash_attention.launches
        out[impl], _ = model.prefill(params, toks, max_len=101)
        launched = fa.flash_attention.launches - before
        assert launched == (cfg.n_layers if impl == "flash" else 0)
    assert float((out["flash"] - out["xla"]).abs().max()) <= 1e-4


def gmm_case(N, D, K, seed=0):
    """Log-scale-like data and well-conditioned factors (diagonal in
    [0.5, 2]): |logpdf| far above 1 at D = 128."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, D, generator=g, device="cuda") * 2.0 + 1.0
    mu = torch.randn(K, D, generator=g, device="cuda") * 2.0
    L = torch.randn(K, D, D, generator=g, device="cuda").tril(-1) * 0.2
    L = L + torch.diag_embed(
        torch.rand(K, D, generator=g, device="cuda") * 1.5 + 0.5)
    inv = gmm.inverse_chol(L).contiguous()
    lw = torch.log_softmax(torch.randn(K, generator=g, device="cuda"), 0)
    return x, mu, inv, lw


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", [(1, 1, 1), (255, 3, 50), (1024, 1, 6),
                                   (300, 8, 8), (2000, 32, 64),
                                   (129, 128, 64), (1001, 1, 1),
                                   (257, 1, 64), (999, 3, 64), (1003, 3, 1),
                                   (333, 128, 1), (300, 128, 64),
                                   (27948, 3, 50)])
def test_gmm_kernel_matches_plain_on_card(N, D, K):
    """Within atol 5e-4 (tests/test_kernels.py's) plus 2e-5 of |logpdf|
    (the D-term sums run in another order), and one launch per call; among
    the shapes, row counts that fill no whole tile of the kernel, one and
    64 components, a last chunk of components narrower than the others
    (D = 32 and 128) and the asset E-step's."""
    _need_card()
    args = gmm_case(N, D, K, seed=N + D + K)
    before = gl.gmm_logpdf.launches
    got = gl.gmm_logpdf(*args)
    torch.cuda.synchronize()
    assert gl.gmm_logpdf.launches == before + 1
    want = ref.gmm_logpdf_ref(*args)
    assert got.shape == (N, K)
    assert bool(((got - want).abs() <= 5e-4 + 2e-5 * want.abs()).all())


@pytest.mark.cuda
def test_gmm_kernel_refuses_what_it_cannot_take():
    """K > 64 or D > 128 on CUDA tensors raise; nothing falls back."""
    _need_card()
    for N, D, K in ((16, 3, 65), (16, 129, 2)):
        args = gmm_case(N, D, K)
        with pytest.raises(ValueError, match="K <= 64"):
            gl.gmm_logpdf(*args)
    x, mu, inv, lw = gmm_case(16, 3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gl.gmm_logpdf(x, mu, inv.transpose(1, 2), lw)


@pytest.mark.cuda
def test_em_on_card_makes_no_host_sync():
    """Every EM iteration launches the kernel once and nothing in the loop
    waits for the card (CUDA sync debug mode raises on a synchronizing
    op); the fit matches the same EM on the CPU within 1e-3."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.cat([torch.randn(3000, 3, generator=g, device="cuda") - 2.0,
                   torch.randn(3000, 3, generator=g, device="cuda") * 0.5
                   + 2.0])
    means0 = gmm.kmeanspp_init(g, x, 8)
    torch.cuda.synchronize()
    before = gl.gmm_logpdf.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit = gmm.em(x, means0, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gl.gmm_logpdf.launches == before + 20
    cpu = gmm.em(x.cpu(), means0.cpu(), 20)
    for name in ("log_weights", "means", "chol"):
        a, b = getattr(fit, name).cpu(), getattr(cpu, name)
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3), name


def ssd_case(B, S, H, P, N, dtype, seed=0):
    """The reference kernel test's scales: x * 0.5, B/C * 0.3,
    dt = softplus(.) * 0.1, A = -exp(. * 0.3)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = (r(B, S, H, P) * 0.5).to(dtype)
    dt = (torch.nn.functional.softplus(r(B, S, H)) * 0.1).to(dtype)
    A = -torch.exp(r(H) * 0.3)
    return x, dt, A, (r(B, S, N) * 0.3).to(dtype), (r(B, S, N) * 0.3).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 2, 64, 32, 64), (2, 256, 4, 32, 64, 128),
    (2, 192, 1, 64, 64, 64), (1, 4096, 4, 64, 64, 128),
    (1, 16, 3, 16, 16, 8), (1, 100, 2, 8, 4, 128),
    (2, 4096, 64, 64, 64, 128), (1, 192, 3, 32, 32, 64),
    (2, 256, 2, 16, 48, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_kernel_matches_plain_on_card(B, S, H, P, N, chunk, dtype):
    """y and h_last within 2e-4 (tests/test_kernels.py's atol) plus 1e-4 of
    |plain| (the kernel sums each chunk's products in another order), and
    one launch per call; among the shapes, the hybrid forward's own
    (2, 4096, 64, 64, 64, 128), and P or N below the tensor-core kernel's
    64-wide rows, which TMA fills with zeros."""
    _need_card()
    args = ssd_case(B, S, H, P, N, dtype, seed=S + H)
    before = ms.mamba2_scan.launches
    y, h = ms.mamba2_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ms.mamba2_scan.launches == before + 1
    yw, hw = ref.mamba2_scan_ref(*args, chunk=min(chunk, S))
    for got, want in ((y, yw), (h, hw)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got - want).abs() <= 2e-4 + 1e-4 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,P,N,chunk,route", [
    (torch.bfloat16, 64, 64, 128, "tensor_cores"),
    (torch.bfloat16, 32, 32, 64, "tensor_cores"),
    (torch.float32, 64, 64, 128, "cuda_cores"),
    (torch.bfloat16, 16, 16, 8, "cuda_cores"),
    (torch.bfloat16, 8, 4, 64, "cuda_cores"),
    (torch.bfloat16, 64, 64, 32, "cuda_cores")])
def test_mamba2_routes_on_card(dtype, P, N, chunk, route):
    """bf16 at the hybrid's and the grid's shapes launches the tensor-core
    kernel; f32 and small or odd shapes launch the CUDA-core kernel, one
    launch counted on that route and none on the other."""
    _need_card()
    args = ssd_case(1, 128, 2, P, N, dtype, seed=P + N + chunk)
    before = dict(ms.mamba2_scan.route_launches)
    y, _ = ms.mamba2_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ms.kernel_route(dtype, P, N, chunk) == route
    after = ms.mamba2_scan.route_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}
    yw, _ = ref.mamba2_scan_ref(*args, chunk=chunk)
    assert bool(((y - yw).abs() <= 2e-4 + 1e-4 * yw.abs()).all())

@pytest.mark.cuda
def test_mamba2_kernel_refuses_what_it_cannot_take():
    """Head dims or states past 64, ragged S, mixed or other types,
    strided inputs and tensors that require grad raise; nothing falls
    back."""
    _need_card()
    x, dt, A, Bm, Cm = ssd_case(1, 64, 2, 128, 16, torch.float32)
    with pytest.raises(ValueError, match="multiples of 4"):
        ms.mamba2_scan(x, dt, A, Bm, Cm, chunk=64)
    x, dt, A, Bm, Cm = ssd_case(1, 96, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ms.mamba2_scan(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(TypeError, match="dt is"):
        ms.mamba2_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="kernel takes"):
        ms.mamba2_scan(x.half(), dt.half(), A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba2_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                       Bm, Cm, chunk=32)
    with pytest.raises(RuntimeError, match="requires grad"):
        ms.mamba2_scan(x.requires_grad_(), dt, A, Bm, Cm, chunk=32)


def queue_matches_plain(r, s, c):
    """One launch through the wrapper, bit for bit against the plain
    version."""
    before = queue_scan.queue_scan.launches
    got = queue_scan.queue_scan(r, s, capacity=c)
    torch.cuda.synchronize()
    assert queue_scan.queue_scan.launches == before + 1
    for a, b in zip(got, ref.queue_scan_ref(r, s, capacity=c)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def tie_jobs(seed, R, N, c):
    """Ready times from a few distinct integers, integer services with
    zeros among them."""
    rng = np.random.default_rng(seed)
    rdy = np.sort(rng.choice(np.arange(0, N, 7), (R, N)), axis=1)
    svc = rng.integers(0, 4, (R, N)) * (1 + c // 8)
    return (torch.from_numpy(rdy.astype(np.float32)).cuda(),
            torch.from_numpy(svc.astype(np.float32)).cuda())


def random_jobs(seed, R, N, c):
    rng = np.random.default_rng(seed)
    rdy = np.sort(rng.uniform(0, 500, (R, N)), axis=1).astype(np.float32)
    svc = rng.exponential(5.0 * c ** 0.5, (R, N)).astype(np.float32)
    return torch.from_numpy(rdy).cuda(), torch.from_numpy(svc).cuda()


# the sweep's capacities and each route's boundaries (kernel_route)
QUEUE_CARD_CAPS = [1, 2, 7, 8, 9, 16, 17, 32, 33, 64, 65, 128, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("c", QUEUE_CARD_CAPS)
def test_queue_kernel_matches_plain_on_card(c):
    """Bit for bit, and one launch per call."""
    _need_card()
    queue_matches_plain(*random_jobs(c, 37, 300, c), c)


@pytest.mark.cuda
@pytest.mark.parametrize("c", QUEUE_CARD_CAPS)
def test_queue_kernel_ties_on_card(c):
    """Tie-heavy integer times with zero services: equal slots everywhere,
    finishes equal to the slot they free."""
    _need_card()
    queue_matches_plain(*tie_jobs(c, 37, 300, c), c)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 9, 33, 65, 256])
def test_queue_kernel_fewer_jobs_than_slots_on_card(c):
    _need_card()
    queue_matches_plain(*random_jobs(c, 5, c - 1, c), c)
    queue_matches_plain(*tie_jobs(c, 5, 1, c), c)


@pytest.mark.cuda
@pytest.mark.parametrize("c,R,N", [(1, 37, 1001), (7, 37, 1001),
                                   (17, 37, 1000), (64, 37, 1001),
                                   (256, 3, 67)])
def test_queue_kernel_ragged_shapes_on_card(c, R, N):
    """R and N that are not multiples of the block's rows or the tile's
    jobs: 4-byte copies where N % 4 != 0, 16-byte ones with a partial last
    tile at N = 1,000."""
    _need_card()
    queue_matches_plain(*random_jobs(c, R, N, c), c)


@pytest.mark.cuda
def test_queue_kernel_unaligned_rows_on_card():
    """Contiguous views 4 bytes past a 16-byte boundary take the 4-byte
    copies."""
    _need_card()
    r, s = random_jobs(5, 37, 300, 9)
    rb, sb = (torch.empty(37 * 300 + 1, device="cuda") for _ in range(2))
    rb[1:] = r.flatten()
    sb[1:] = s.flatten()
    queue_matches_plain(rb[1:].view(37, 300), sb[1:].view(37, 300), 9)


@pytest.mark.cuda
def test_queue_every_route_on_card():
    """Every route the source instantiates, at its full width and at just
    over half of it, through the C entry point that takes the route."""
    _need_card()
    from repro_torch.kernels import _build
    lib = _build.load("queue_scan", queue_scan._QUEUE_SIGNATURES)
    for S, G in queue_scan.ROUTES:
        for c in sorted({S * G, S * G // 2 + 1}):
            for r, s in (random_jobs(S * G, 37, 300, c),
                         tie_jobs(S * G, 37, 300, c)):
                st, fi = torch.empty_like(r), torch.empty_like(r)
                err = lib.queue_scan_launch_route(
                    r.data_ptr(), s.data_ptr(), st.data_ptr(), fi.data_ptr(),
                    37, 300, c, S, G, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                assert err == 0, (S, G, c)
                for a, b in zip((st, fi), ref.queue_scan_ref(r, s,
                                                             capacity=c)):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (S, G, c)


@pytest.mark.cuda
def test_queue_route_holds_every_capacity_on_card():
    """The route the C entry point takes at every capacity is one the
    source instantiates, and its width holds the capacity."""
    _need_card()
    for c in range(1, queue_scan.MAX_CAPACITY + 1):
        S, G = queue_scan.kernel_route(c)
        assert (S, G) in queue_scan.ROUTES and S * G >= c and 32 % G == 0
    with pytest.raises(ValueError, match="capacity"):
        queue_scan.kernel_route(queue_scan.MAX_CAPACITY + 1)


@pytest.mark.cuda
def test_queue_kernel_refuses_what_it_cannot_take():
    _need_card()
    r = torch.zeros(2, 8, device="cuda")
    with pytest.raises(ValueError, match="capacity <= 256"):
        queue_scan.queue_scan(r, r, capacity=257)


@pytest.mark.cuda
def test_hybrid_kernel_matches_plain_on_card():
    """The smoke hybrid in f32 (no TF32): the loss through the SSD kernel
    (one launch per Mamba block) equals the plain path's within 1e-5, and
    the prefill, which takes the chunked scan from a zero state, launches
    it no time."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    loss = {}
    for impl in ("mamba_kernel", "xla"):
        cfg = configs.get_smoke_config("zamba2-1.2b", ssm_impl=impl)
        model = get_model(cfg)
        params = model.init(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))
        before = ms.mamba2_scan.launches
        loss[impl], _ = model.loss_fn(params, {"tokens": toks,
                                               "labels": toks})
        assert ms.mamba2_scan.launches - before == (
            cfg.n_layers if impl == "mamba_kernel" else 0)
        before = ms.mamba2_scan.launches
        logits, _ = model.prefill(params, toks, max_len=65)
        assert ms.mamba2_scan.launches == before
        assert bool(torch.isfinite(logits).all())
    assert abs(float(loss["mamba_kernel"] - loss["xla"])) <= 1e-5


def _grad_cases():
    """Each kernel's call with one float input that requires grad: the
    name of that input and the call."""
    q = torch.randn(1, 128, 4, 64, device="cuda", dtype=torch.bfloat16)
    x, dt, A, Bm, Cm = ssd_case(1, 128, 2, 64, 32, torch.bfloat16)
    gx, mu, inv, lw = gmm_case(64, 3, 4)
    r, s = random_jobs(0, 2, 64, 4)
    res, pkey, wave, free = make_case(1, 2, 300, 2, 0.3, True)
    return [
        ("flash_attention", 'attn_impl="xla"', q,
         lambda t: fa.flash_attention(t, q, q)),
        ("mamba2_scan", 'ssm_impl="xla"', x,
         lambda t: ms.mamba2_scan(t, dt, A, Bm, Cm, chunk=64)),
        ("gmm_logpdf", "gmm_logpdf_ref", mu,
         lambda t: gl.gmm_logpdf(gx, t, inv, lw)),
        ("queue_scan", "queue_scan_ref", s,
         lambda t: queue_scan.queue_scan(r, t, capacity=4)),
        ("fused_admission", "admission_mask_dense", pkey,
         lambda t: queue_scan.fused_admission(res, t, wave, free))]


@pytest.mark.cuda
def test_kernels_refuse_autograd_on_card():
    """No kernel has a backward (nor has the reference's): an input that
    requires grad, in grad mode, raises before the launch and names the
    plain route; under ``torch.no_grad()`` the kernel launches."""
    _need_card()
    kernels = {"flash_attention": fa.flash_attention,
               "mamba2_scan": ms.mamba2_scan, "gmm_logpdf": gl.gmm_logpdf,
               "queue_scan": queue_scan.queue_scan,
               "fused_admission": queue_scan.fused_admission}
    for name, plain, t, call in _grad_cases():
        t = t.clone().requires_grad_()
        before = kernels[name].launches
        with pytest.raises(RuntimeError, match="requires grad") as e:
            call(t)
        assert plain in str(e.value) and kernels[name].launches == before
        with torch.no_grad():
            call(t)
        torch.cuda.synchronize()
        assert kernels[name].launches == before + 1, name


@pytest.mark.cuda
def test_training_resumes_bit_for_bit_on_card():
    """``chip_smoke.py`` phase 16(c) at 4 steps: a fault at step 3 rolls
    back to step 2's checkpoint; under deterministic algorithms the final
    checkpoint and state equal the uninterrupted run's bit for bit."""
    _need_card()
    restarts = _chip_smoke().resume_twin(torch, 4, 2, fault_at=(3,))
    assert restarts == (1, 0, [2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,Hkv", [(80, 32, 32), (80, 4, 1), (48, 4, 2),
                                     (96, 8, 2)])
def test_flash_padded_head_dim_matches_plain_on_card(D, H, Hkv, dtype):
    """Head dims the kernel takes zero-padded (stablelm-3b's 80 among
    them): one launch, within 1e-5 (f32) / 2e-2 and 1e-2 of each row's
    norm (bf16) of the plain version at the true head dim."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(D + H)
    q, k, v = (torch.randn(2, 512, h, D, generator=g, device="cuda").to(dtype)
               for h in (H, Hkv, Hkv))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = ref.flash_attention_ref(q, k, v)
    diff = got.float() - want.float()
    assert float(diff.abs().max()) <= (1e-5 if dtype == torch.float32
                                       else 2e-2)
    if dtype == torch.bfloat16:
        row_rel = diff.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(row_rel.max()) <= 1e-2


@pytest.mark.cuda
def test_meta_count_equals_the_card_step_and_prices_on_h100():
    """The dry-run's meta count of a train step (the smoke granite-20b:
    the gelu MLP, MQA; remat per block, two microbatches) equals the same
    step's count on the card, FLOPs and bytes: the card dispatches the
    operations the meta run counts. Priced on the H100 spec."""
    _need_card()
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import costmodel
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = configs.get_smoke_config("granite-20b", remat="block")
    spec = ShapeSpec("t", "train", 128, 8)
    step, _ = dryrun.cell_step(cfg, spec, microbatches=2)
    meta = dryrun.count(step)
    model = get_model(cfg)
    params = trainer.trainable(model.init(0, "cuda"))
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_opt_state(opt_cfg, params)
    tok = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda",
                        dtype=torch.int32)
    grads_of = trainer._grad_fn(model, 2)

    def card_step():
        grads, loss, _ = grads_of(params, {"tokens": tok, "labels": tok})
        return adamw.apply_updates(opt_cfg, params, grads, opt)[:2] + (loss,)

    card = dryrun.count(card_step)
    assert card["flops"] == meta["flops"] > 0
    assert card["bytes"] == meta["bytes"] > 0
    rec = {"kind": "train", "seq_len": 128, "global_batch": 8,
           "n_devices": 1, "flops_per_device": meta["flops"],
           "bytes_accessed_per_device": meta["bytes"], "collectives": {}}
    terms = costmodel.roofline_terms(rec)
    assert terms["step_s"] == max(meta["flops"] / 989.4e12,
                                  meta["bytes"] / 3.35e12)
