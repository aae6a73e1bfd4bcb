"""The port's gradient compression (``parallel/compression.py``) against the
reference's, on the CPU: bit for bit.

Leaves are made with numpy from a seed (f32 and bf16; with ties, exact
zeros and a constant leaf), carried into both packages; ``g_hat``, the new
error and the wire bytes must equal the reference's exactly, over three
rounds of error feedback. ``compressed_psum_pod`` with ``group=None`` (a
group of one) equals its leaves' compression; over a one-rank gloo group
it equals ``group=None`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.parallel import compression as RC
from repro_torch.models import weights
from repro_torch.models.common import tree_leaves
from repro_torch.parallel import compression as C

KINDS = [("int8", True), ("topk", True), ("topk", False), ("none", True),
         ("int8", False)]


def t(a):
    """A numpy (or JAX) array as a CPU tensor, bf16 through its bits."""
    return weights._tensor(np.asarray(a))


def same(got, want):
    """Equal bit for bit (dtype, shape, bits; NaN-free)."""
    want = np.asarray(want)
    w = t(want)
    assert got.dtype == w.dtype and tuple(got.shape) == tuple(w.shape)
    assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16
                       else got, w.view(torch.int16)
                       if w.dtype == torch.bfloat16 else w)


def leaves(seed):
    """Seeded leaves: a wide f32, a bf16 one, ties at the top-k threshold,
    exact zeros and a constant leaf."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(0, 1e-3, (64, 48)).astype(np.float32)
    bf = jnp.asarray(rng.normal(0, 1.0, (33, 17)), jnp.bfloat16)
    ties = np.round(rng.normal(0, 2.0, (40, 10))).astype(np.float32)
    zeros = np.where(rng.random((16, 16)) < 0.7, 0.0,
                     rng.normal(0, 1.0, (16, 16))).astype(np.float32)
    const = np.full((8, 8), -0.25, np.float32)
    return {"a": f32, "b": np.asarray(bf), "c": ties, "d": zeros, "e": const}


def test_int8_compression_error_feedback():
    """The reference's test of the same name, on the port."""
    rng = np.random.default_rng(0)
    cfg = C.CompressionConfig(kind="int8", error_feedback=True)
    g = torch.from_numpy(rng.normal(0, 1e-3, (256, 64)).astype(np.float32))
    err = torch.zeros_like(g, dtype=torch.bfloat16)
    g_hat, new_err, wire = C.compress_leaf(cfg, g, err)
    step = float(g.abs().max()) / 127.0
    assert float((g_hat - g).abs().max()) <= step
    assert wire < g.numel() * 4
    assert float((new_err.float() - (g - g_hat)).abs().max()) < step


def test_topk_compression_keeps_largest():
    """The reference's test of the same name, on the port."""
    cfg = C.CompressionConfig(kind="topk", topk_ratio=0.1,
                              error_feedback=False)
    g = torch.arange(100, dtype=torch.float32).reshape(10, 10)
    g_hat, _, wire = C.compress_leaf(cfg, g, None)
    assert int((g_hat != 0).sum()) == 10
    assert float(g_hat.max()) == 99.0
    assert wire == 10 * 8


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_topk_mask_equal_reference(seed):
    for name, a in leaves(seed).items():
        g = a.astype(np.float32)
        q, s = C.quantize_int8(t(g))
        rq, rs = RC.quantize_int8(jnp.asarray(g))
        same(q, rq)
        same(s, rs)
        same(C.dequantize_int8(q, s), RC.dequantize_int8(rq, rs))
        for ratio in (0.05, 0.1, 0.5):
            same(C.topk_mask(t(g), ratio), RC.topk_mask(jnp.asarray(g), ratio))


@pytest.mark.parametrize("kind,fb", KINDS)
def test_compress_leaf_equals_reference_over_rounds(kind, fb):
    """Three rounds of error feedback from the bf16 initial state: every
    ``g_hat``, new error and wire count equal."""
    cfg = C.CompressionConfig(kind=kind, topk_ratio=0.05, error_feedback=fb)
    rcfg = RC.CompressionConfig(kind=kind, topk_ratio=0.05,
                                error_feedback=fb)
    for name, a in leaves(2).items():
        err, rerr = (torch.zeros(a.shape, dtype=torch.bfloat16),
                     jnp.zeros(a.shape, jnp.bfloat16))
        for rnd in range(3):
            g = a if rnd == 0 else leaves(10 + rnd)[name]
            g_hat, ne, wire = C.compress_leaf(cfg, t(g), err)
            rg, rne, rwire = RC.compress_leaf(rcfg, jnp.asarray(g), rerr)
            same(g_hat, rg)
            assert wire == rwire and isinstance(wire, int)
            if rne is None:
                assert ne is None
                break
            same(ne, rne)
            assert ne.dtype == torch.float32
            err, rerr = ne, rne


def test_init_error_state_equals_reference():
    params = {k: t(v) for k, v in leaves(3).items()}
    for kind, fb in KINDS:
        cfg = C.CompressionConfig(kind=kind, error_feedback=fb)
        got = C.init_error_state(cfg, params)
        want = RC.init_error_state(RC.CompressionConfig(kind=kind,
                                                        error_feedback=fb),
                                   leaves(3))
        if want is None:
            assert got is None
            continue
        for k in want:
            same(got[k], want[k])


@pytest.mark.parametrize("kind", ["int8", "topk", "none"])
def test_compressed_psum_without_group_is_the_leaves_compression(kind):
    cfg = C.CompressionConfig(kind=kind)
    grads = {"x": {k: t(v) for k, v in leaves(4).items()},
             "y": t(leaves(5)["b"])}
    err = C.init_error_state(cfg, grads)
    avg, new_err, wire = C.compressed_psum_pod(cfg, grads, err)
    assert sorted(avg) == ["x", "y"] and sorted(avg["x"]) == sorted(grads["x"])
    flat_e = tree_leaves(err) if err is not None else [None] * 6
    total = 0
    for g, e, got, ne in zip(tree_leaves(grads), flat_e, tree_leaves(avg),
                             tree_leaves(new_err) if new_err is not None
                             else [None] * 6):
        g_hat, want_e, w = C.compress_leaf(cfg, g, e)
        total += w
        assert torch.equal(got, g_hat) and got.dtype == g.dtype
        assert (ne is None) == (want_e is None)
        if ne is not None:
            assert torch.equal(ne, want_e)
    assert wire == total


def test_compressed_psum_over_one_rank_gloo_group():
    """A one-rank gloo group (in-process store) sums nothing in: the
    averaged leaves equal ``group=None``'s bit for bit."""
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        cfg = C.CompressionConfig(kind="topk", topk_ratio=0.05)
        grads = {k: t(v) for k, v in leaves(6).items()}
        err = C.init_error_state(cfg, grads)
        want = C.compressed_psum_pod(cfg, grads, err)
        got = C.compressed_psum_pod(cfg, grads, err, group=dist.group.WORLD)
        for a, b in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                        tree_leaves(want[0]) + tree_leaves(want[1])):
            assert torch.equal(a, b) and a.dtype == b.dtype
        assert got[2] == want[2]
    finally:
        dist.destroy_process_group()
