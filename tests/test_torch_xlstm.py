"""The port's xLSTM family (``models/xlstm.py``, ``XLSTM``, ``xlstm-125m``)
against the reference's, on the CPU.

Blocks: the reference's f32 mLSTM and sLSTM weights (``init_*`` from
``PRNGKey(0)`` at width 64, 4 heads) carried into the port by
``weights.from_reference``, inputs and states made with numpy from a seed.
The f32 blocks agree within 1e-5 of each output's largest |value| (the
outputs reach 10: the reference's ``wo`` is drawn at 1/sqrt(H)) at every
chunk length and through the step recurrence; the port's chunkwise form
equals its own step recurrence within the same; bf16 blocks (the same
weights rounded) within 2e-2 of each output row's norm (``||got - want||
/ ||want||`` per token).

Model: ``xlstm-125m``'s smoke config (4 layers, width 64) in f32 with the
reference's weights: the loss within 1e-4, the gradients'
``global_norm(g_port - g_ref) / global_norm(g_ref)`` below 1e-5, the
prefill and two decode steps' logits within 1e-3 and the states within
1e-4 plus 1e-5 of each leaf's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xlstm as JXL
from repro.models.transformer import get_model as jget_model
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import run_training
from repro_torch.models import weights
from repro_torch.models import xlstm as XL
from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.transformer import XLSTM, get_model
from repro_torch.optim import adamw

ARCH = "xlstm-125m"
D, H = 64, 4
B, S = 2, 32
BLOCK_ATOL = 1e-5
BF16_ROW_TOL = 2e-2
LOSS_ATOL = 1e-4
GRAD_REL_TOL = 1e-5
LOGIT_ATOL = 1e-3
CACHE_ATOL, CACHE_RTOL = 1e-4, 1e-5
N_PARAMS = 116_269_872       # the reference's full config


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def blocks():
    """The reference's f32 block weights as numpy trees."""
    mp, _ = JXL.init_mlstm(jax.random.PRNGKey(0), D, H, jnp.float32)
    sp, _ = JXL.init_slstm(jax.random.PRNGKey(1), D, H, jnp.float32)
    return np_tree(mp), np_tree(sp)


def port(tree, dtype=torch.float32):
    return tree_map(lambda t: t.to(dtype),
                    weights.from_reference(tree, device="cpu"))


def jax_tree(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def x_in(seed, length=S, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, length, D)) * scale).astype(np.float32)


def mlstm_state(seed):
    rng = np.random.default_rng(seed)
    hd = D // H
    return {"C": (rng.standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32),
            "n": (rng.standard_normal((B, H, hd)) * 0.5).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32)}


def slstm_state(seed):
    rng = np.random.default_rng(seed)
    shape = (B, H, D // H)
    return {"c": rng.standard_normal(shape).astype(np.float32),
            "n": (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32),
            "h": (rng.standard_normal(shape) * 0.5).astype(np.float32),
            "m": rng.standard_normal(shape).astype(np.float32)}


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol)


def close_scaled(got, want, rtol=BLOCK_ATOL):
    """Within ``rtol`` of ``want``'s largest |value| (at least 1)."""
    want = np.asarray(want, np.float32)
    close(got, want, rtol * max(1.0, float(np.abs(want).max())))


def close_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == (torch.float32 if want[k].dtype == jnp.float32
                                else torch.bfloat16), k
        close_scaled(got[k], want[k])


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- blocks

@pytest.mark.parametrize("q_chunk", [S, S // 4, S // 8, -1])
def test_mlstm_chunkwise_matches_reference(blocks, q_chunk):
    mp = blocks[0]
    x = x_in(0)
    want, wst = JXL.apply_mlstm(jax_tree(mp), jnp.asarray(x), q_chunk=q_chunk)
    got, gst = XL.apply_mlstm(port(mp), t(x), q_chunk=q_chunk)
    close_scaled(got, want)
    close_tree(gst, wst)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_step_recurrence_matches_reference(blocks, with_state):
    """With a state (any S) or at S = 1 without one: the step path."""
    mp = blocks[0]
    x = x_in(1, S // 2 if with_state else 1)
    st = mlstm_state(2) if with_state else None
    want, wst = JXL.apply_mlstm(jax_tree(mp), jnp.asarray(x),
                                state=None if st is None else jax_tree(st))
    got, gst = XL.apply_mlstm(port(mp), t(x),
                              state=None if st is None
                              else {k: t(v) for k, v in st.items()})
    close_scaled(got, want)
    close_tree(gst, wst)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_matches_reference(blocks, with_state):
    sp = blocks[1]
    x = x_in(3)
    st = slstm_state(4) if with_state else None
    want, wst = JXL.apply_slstm(jax_tree(sp), jnp.asarray(x),
                                state=None if st is None else jax_tree(st))
    got, gst = XL.apply_slstm(port(sp), t(x),
                              state=None if st is None
                              else {k: t(v) for k, v in st.items()})
    close_scaled(got, want)
    close_tree(gst, wst)


@pytest.mark.parametrize("q_chunk", [S, S // 4, S // 8])
def test_chunkwise_equals_step_recurrence(blocks, q_chunk):
    """The port's chunkwise form against its own step recurrence from the
    same (initial) state: outputs and final states."""
    p = port(blocks[0])
    x = t(x_in(5))
    got, gst = XL.apply_mlstm(p, x, q_chunk=q_chunk)
    hd = D // H
    st0 = {"C": torch.zeros((B, H, hd, hd)), "n": torch.zeros((B, H, hd)),
           "m": torch.full((B, H), -1e30)}
    want, wst = XL.apply_mlstm(p, x, state=st0)
    close_scaled(got, want.numpy())
    for k in wst:
        close_scaled(gst[k], wst[k].numpy())


def row_rel(got, want) -> float:
    """The largest per-token ``||got - want|| / ||want||``."""
    got, want = np.asarray(got.float()), np.asarray(want, np.float32)
    num = np.linalg.norm(got - want, axis=-1)
    return float((num / np.linalg.norm(want, axis=-1)).max())


@pytest.mark.parametrize("block,q_chunk,state", [
    ("mlstm", S // 4, None), ("mlstm", -1, "m"), ("slstm", -1, None),
    ("slstm", -1, "s")])
def test_bf16_blocks_match_reference(blocks, block, q_chunk, state):
    """The same weights and inputs rounded to bf16 (the states stay in
    their f32 or bf16 as the reference keeps them)."""
    mp, sp = blocks
    x = x_in(6, S // 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    if block == "mlstm":
        st = None
        if state:
            st = mlstm_state(7)
            st = {"C": jnp.asarray(st["C"], jnp.bfloat16),
                  "n": jnp.asarray(st["n"], jnp.bfloat16),
                  "m": jnp.asarray(st["m"])}
        want, _ = JXL.apply_mlstm(jax_tree(mp, jnp.bfloat16), xb, state=st,
                                  q_chunk=q_chunk)
        got, _ = XL.apply_mlstm(
            port(mp, torch.bfloat16), t(x).to(torch.bfloat16),
            state=None if st is None else {k: weights._tensor(np.asarray(v))
                                           for k, v in st.items()},
            q_chunk=q_chunk)
    else:
        st = slstm_state(8) if state else None
        want, _ = JXL.apply_slstm(jax_tree(sp, jnp.bfloat16), xb,
                                  state=None if st is None else jax_tree(st))
        got, _ = XL.apply_slstm(port(sp, torch.bfloat16),
                                t(x).to(torch.bfloat16),
                                state=None if st is None
                                else {k: t(v) for k, v in st.items()})
    assert got.dtype == torch.bfloat16
    assert row_rel(got, np.asarray(want.astype(jnp.float32))) < BF16_ROW_TOL


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def ref_params():
    params, _ = jget_model(jconfigs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0))
    return np_tree(params)


def pair(**kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)
    return jget_model(jcfg), get_model(configs.get_smoke_config(ARCH, **kw))


def tokens(seed, length=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, (B, length)).astype(np.int32)


def test_config_mirrors_reference():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        got = dataclasses.asdict(getattr(configs, get)(ARCH))
        assert got == want, get
    assert isinstance(get_model(configs.get_config(ARCH)), XLSTM)


def test_full_config_shapes_match_reference():
    """Every leaf of the full-width tree has the reference's shape and
    bf16; the count is the reference's (shapes only)."""
    cfg = configs.get_config(ARCH)
    jm = jget_model(jconfigs.get_config(ARCH))
    want = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    got = XLSTM(cfg).init(0, device="meta")
    n = 0
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        x = got
        for key in path:
            x = x[key.key]
        assert tuple(x.shape) == a.shape, path
        assert x.dtype == torch.bfloat16
        n += x.numel()
    assert n == N_PARAMS == cfg.param_count()
    assert len(list(tree_items(got))) == len(jax.tree_util.tree_leaves(want))
    assert tuple(got["supers"]["slstm"]["ri"].shape) == (6, 4, 192, 192)


def test_param_count_matches_reference():
    for get in ("get_config", "get_smoke_config"):
        assert (getattr(configs, get)(ARCH).param_count()
                == getattr(jconfigs, get)(ARCH).param_count())


@pytest.mark.parametrize("q_chunk", [-1, S // 4])
def test_loss_matches_reference(ref_params, q_chunk):
    jm, tm = pair(attn_q_chunk=q_chunk)
    toks, labels = tokens(1), tokens(2)
    want, _ = jm.loss_fn(jax_tree(ref_params),
                         {"tokens": jnp.asarray(toks),
                          "labels": jnp.asarray(labels)})
    got, aux = tm.loss_fn(weights.from_reference(ref_params, device="cpu"),
                          {"tokens": t(toks), "labels": t(labels)})
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got, want, LOSS_ATOL)
    assert aux["ce_loss"] is got


@pytest.mark.parametrize("remat", ["none", "block"])
def test_gradients_match_reference(ref_params, remat):
    jm, tm = pair(attn_q_chunk=S // 4, remat=remat)
    batch = {"tokens": tokens(3), "labels": tokens(4)}
    jg = jax.grad(lambda p: jm.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
            jax_tree(ref_params))
    params = weights.from_reference(ref_params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_(True)
    loss, _ = tm.loss_fn(params, {k: t(v) for k, v in batch.items()})
    loss.backward()
    got = tree_map(lambda p: p.grad, params)
    want = weights.from_reference(np_tree(jg), device="cpu")
    diff = tree_map(lambda a, b: a - b, got, want)
    assert float(adamw.global_norm(diff) / adamw.global_norm(want)) \
        < GRAD_REL_TOL


def test_prefill_and_two_decode_steps_match_reference(ref_params):
    jm, tm = pair()
    jp = jax_tree(ref_params)
    tp = weights.from_reference(ref_params, device="cpu")
    toks = tokens(5, 13)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    tl, tc = tm.prefill(tp, t(toks), max_len=16)
    close(tl, jl, LOGIT_ATOL)

    def cache_close(tc, jc):
        for path, a in jax.tree_util.tree_leaves_with_path(jc):
            x = tc
            for key in path:
                x = x[key.key]
            assert x.dtype == (torch.float32 if a.dtype == jnp.float32
                               else torch.bfloat16), path
            close(x, a, CACHE_ATOL + CACHE_RTOL * float(np.abs(a).max()))

    cache_close(tc, jc)
    for i in range(2):
        tok = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(13 + i))
        tl, tc = tm.decode_step(tp, t(tok), tc, 13 + i)
        close(tl, jl, LOGIT_ATOL)
    cache_close(tc, jc)


def test_init_cache_matches_reference():
    jm, tm = pair()
    want = jm.init_cache(3, 8)
    got = tm.init_cache(3, 8, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        x = got
        for key in path:
            x = x[key.key]
        assert tuple(x.shape) == a.shape and x.dtype == torch.float32
        assert np.array_equal(x.numpy(), np.asarray(a)), path


def test_teacher_forced_decode_equals_chunkwise_forward():
    """Prefill then decode over a sequence, token by token, gives the
    chunkwise forward's logits at every position (one model, f32)."""
    cfg = configs.get_smoke_config(ARCH, attn_q_chunk=4)
    m = get_model(cfg)
    params = m.init(0, "cpu")
    toks = t(tokens(6, 12))
    with torch.no_grad():
        full = m._forward(params, toks)
        logits, cache = m.prefill(params, toks[:, :8], 16)
        got = [logits]
        for i in range(8, 12):
            logits, cache = m.decode_step(params, toks[:, i:i + 1], cache, i)
            got.append(logits)
    for j, g in zip(range(7, 12), got):
        close(g[:, 0], full[:, j].numpy(), 1e-4)


def test_serve_and_train_launchers_run_the_smoke_model(tmp_path):
    out = run_serving(ARCH, batch=2, prompt_len=8, new_tokens=4,
                      device="cpu")
    assert out["generated_shape"] == [2, 4] and out["logits_finite"]
    assert out["all_in_vocab"] and out["attn_impl"] == "flash"
    res = run_training(ARCH, steps=3, batch=2, seq=16, log_every=1,
                       ckpt_dir=str(tmp_path), device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))


# ---------------------------------------------------------------- dry-run

@pytest.mark.parametrize("kind,S,q_chunk,n_layers,want_at", [
    # 6 chunks of 16 from 2 and 3, 3 super blocks from 1 and 2
    ("train", 96, 16, 6, {"seq_len": [32, 48], "n_layers": [2, 4]}),
    # the cells' chunk (S > 512: 128), at one super block
    ("train", 640, -1, 2, [256, 384]),
    # the step recurrence per prompt token
    ("prefill", 56, -1, 6, {"seq_len": [8, 16], "n_layers": [2, 4]})])
def test_dryrun_extrapolated_count_equals_full_count(kind, S, q_chunk,
                                                     n_layers, want_at):
    """The count extrapolated from two lengths (and two depths) equals the
    whole step's count: FLOPs, bytes and the output's bytes, exactly (smoke
    width, bf16 with remat, as the full config)."""
    cfg = configs.get_smoke_config(ARCH, n_layers=n_layers,
                                   attn_q_chunk=q_chunk,
                                   param_dtype="bfloat16",
                                   compute_dtype="bfloat16", remat="block")
    spec = configs.ShapeSpec("t", kind, S, 4)
    got, arg_bytes, at = dryrun.count_cell(cfg, spec, microbatches=1)
    assert at == want_at
    step, want_args = dryrun.cell_step(cfg, spec, microbatches=1)
    want = dryrun.count(step)
    assert arg_bytes == want_args
    for key in ("flops", "bytes", "output_bytes"):
        assert got[key] == want[key], key
    assert isinstance(got["flops"], int) and got["flops"] > 0


def test_dryrun_counts_whole_what_is_not_affine():
    """A train cell whose chunk is its whole sequence (S <= 512), and every
    decode cell, are counted whole; the xLSTM cells of the table carry
    their lengths and depths."""
    cfg = configs.get_config(ARCH)
    assert dryrun.count_lengths(cfg, configs.ShapeSpec("t", "train", 512,
                                                       2)) is None
    assert dryrun.count_lengths(cfg, configs.SHAPES["decode_32k"]) is None
    assert dryrun.count_lengths(cfg, configs.SHAPES["train_4k"]) == (
        256, 384, {"attn_q_chunk": 128}, (2, 4))
    assert dryrun.count_lengths(cfg, configs.SHAPES["prefill_32k"]) == (
        8, 16, {}, (2, 4))
    assert dryrun.count_lengths(configs.get_smoke_config(ARCH),
                                configs.SHAPES["train_4k"])[3] is None
    assert dryrun.count_lengths(configs.get_config("zamba2-1.2b"),
                                configs.SHAPES["train_4k"]) is None
