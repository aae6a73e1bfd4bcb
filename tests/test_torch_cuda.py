"""The port on the card: each kernel against its plain version, the
engine through the kernel against the engine through the plain version,
the serving path through the flash kernel against the plain path, and the
EM through the GMM kernel with no host sync per iteration.

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

from repro_torch import configs
from repro_torch.core import batching, des, gmm, vdes, workload
from repro_torch.core import model as M
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm_logpdf as gl
from repro_torch.kernels import queue_scan, ref
from repro_torch.models.transformer import get_model
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 1, 4, 4, 64), (2, 200, 4, 2, 64), (4, 1024, 32, 8, 64),
    (1, 256, 8, 1, 128), (2, 130, 4, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(B, S, H, Hkv, D, dtype, causal):
    """Within tests/test_kernels.py's tolerances (1e-5 f32, 2e-2 bf16), and
    one launch counted per call."""
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
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take():
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    _need_card()
    q = torch.randn(1, 8, 2, 96, device="cuda")
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
                                   (129, 128, 64)])
def test_gmm_kernel_matches_plain_on_card(N, D, K):
    """Within atol 5e-4 (tests/test_kernels.py's) plus 2e-5 of |logpdf|
    (the D-term sums run in another order), and one launch per call."""
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
