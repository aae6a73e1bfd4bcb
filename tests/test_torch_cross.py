"""The cross-attention families (``attention.init_cross``/``apply_cross``,
``DecoderLM``'s VLM plan, ``EncDec``; llama-3.2-vision-90b and
seamless-m4t-large-v2) against the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights come from the reference's
init through ``models.weights.from_reference``. Under ``attn_impl="flash"``
the port runs its kernel's plain version on the CPU and the reference its
Pallas kernel in interpret mode.

Tolerances: f32 values of order one within ``ATOL = 1e-5`` (the two
frameworks sum in other orders), as ``tests/test_torch_moe.py`` holds them;
the losses within 1e-5 and the gradients' ``global_norm(g_port - g_ref) /
global_norm(g_ref)`` below 1e-5; plans, parameter counts, specs and shapes
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCN
from repro.models import attention as rattn
from repro.models.transformer import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.serving.engine import ServeConfig as RServe
from repro.serving.engine import ServingEngine as REngine
from repro.train import trainer as ref_trainer
from repro_torch import configs as CN
from repro_torch.data import pipeline as data
from repro_torch.launch import dryrun
from repro_torch.launch.serve import run_serving
from repro_torch.launch.train import run_training
from repro_torch.models import attention, common
from repro_torch.models.transformer import EncDec, get_model
from repro_torch.models.weights import from_reference
from repro_torch.optim import adamw
from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                        make_prefill_step, make_serve_step)
from repro_torch.train import trainer

ATOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
VLM, AUDIO = "llama-3.2-vision-90b", "seamless-m4t-large-v2"
ARCHS = (VLM, AUDIO)
IMPLS = ("xla", "flash")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_tree(tree):
    return from_reference(to_np(tree), "cpu")


def rel_err(got, want) -> float:
    diff = common.tree_map(lambda a, b: a.float() - b.float(), got, want)
    return float(adamw.global_norm(diff) / adamw.global_norm(want))


def reference(arch, **overrides):
    cfg = dataclasses.replace(RCN.get_smoke_config(arch), **overrides)
    model = ref_get_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))[0]


def ctx_of(cfg, B=2, seed=3, S=16):
    """The smoke model's second input: the VLM's patches ``[B, n_ctx,
    d_ctx]``, the audio model's frames ``[B, n_ctx, d_model]`` (``S // 4``
    of them in a train batch, as ``input_specs`` has it)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape = (B, cfg.n_ctx, cfg.d_ctx)
    else:
        shape = (B, S // 4 if S else cfg.n_ctx, cfg.d_model)
    return rng.standard_normal(shape).astype(np.float32)


def tokens_of(cfg, B=2, S=16, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def flat(tree, prefix=()):
    """``(path, leaf)`` of nested dicts (keys sorted) and tuples, as JAX's
    tree functions see them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + (i,))
    else:
        yield prefix, tree


def assert_trees_close(got, want):
    g, w = list(flat(got)), list(flat(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------- the layer

@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("n_kv", [4, 2], ids=["rep1", "rep2"])
def test_apply_cross_matches_reference(n_kv, use_cache):
    """4 query heads over ``n_kv`` KV heads: ``y`` and the K/V the layer
    returns, with K/V projected from ``ctx`` and with them passed back as
    ``kv_cache`` (no ``ctx``), as a decode step does."""
    rp, _ = rattn.init_cross(jax.random.PRNGKey(n_kv), 32, 4, n_kv, 8, 24,
                             jnp.float32)
    rng = np.random.default_rng(n_kv)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    p = port_tree(rp)
    want, wkv = rattn.apply_cross(rp, jnp.asarray(x), jnp.asarray(ctx))
    got, gkv = attention.apply_cross(p, torch.from_numpy(x),
                                     torch.from_numpy(ctx))
    if use_cache:
        want, wkv = rattn.apply_cross(rp, jnp.asarray(x[:, -1:]),
                                      kv_cache=wkv)
        kv = tuple(t.clone() for t in gkv)
        got, gkv = attention.apply_cross(p, torch.from_numpy(x[:, -1:]),
                                         kv_cache=kv)
        assert gkv[0] is kv[0] and gkv[1] is kv[1]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for g, w in zip(gkv, wkv):
        assert tuple(g.shape) == w.shape == (2, 7, n_kv, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_init_cross_leaves_equal_reference_shapes():
    want, want_axes = rattn.init_cross(jax.random.PRNGKey(0), 32, 4, 2, 8,
                                       24, jnp.float32)
    got, axes = attention.init_cross(torch.Generator().manual_seed(0), 32, 4,
                                     2, 8, 24, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert axes == want_axes


@pytest.mark.parametrize("Sq,Skv,chunks", [(1, 1601, 1), (1, 4096, 1),
                                           (512, 1601, 1), (4096, 4096, 4)])
def test_cross_q_chunk_rule(Sq, Skv, chunks, monkeypatch):
    """Non-causal attention takes the plain path under ``impl="flash"``;
    one query against 1,601 or 4,096 keys is one score block (``q_chunk =
    Sq``), the encoder's 4,096 queries four of 1,024."""
    calls = []
    core = attention._attn_core

    def spy(q, *a):
        calls.append(q.shape[1])
        return core(q, *a)

    monkeypatch.setattr(attention, "_attn_core", spy)
    monkeypatch.setattr(attention, "flash_attention", None)
    rng = np.random.default_rng(Sq)
    q = torch.from_numpy(rng.standard_normal((1, Sq, 2, 8)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, Skv, 1, 8)).astype(
        np.float32))
    out = attention.sdpa(q, k, k, causal=False, impl="flash")
    assert calls == [Sq // chunks] * chunks
    want = rattn.sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, k)),
                      causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------- the VLM

@pytest.mark.parametrize("n_layers,plan", [
    (5, [("vlm_super", 1, 4)]),
    (7, [("vlm_super", 1, 4), ("dense", 2, 0)]),
    (10, [("vlm_super", 2, 4)])])
def test_vlm_plan_and_tree_equal_reference(n_layers, plan):
    rmodel, rparams = reference(VLM, n_layers=n_layers)
    model = get_model(CN.get_smoke_config(VLM, n_layers=n_layers))
    assert model.plan == rmodel.plan == plan
    got = [(p, tuple(t.shape)) for p, t in flat(model.init(0, "cpu"))]
    assert got == [(p, t.shape) for p, t in flat(rparams)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_layers", [5, 7, 10])
def test_vlm_forward_and_loss_match_reference(n_layers, impl):
    rmodel, rparams = reference(VLM, n_layers=n_layers, attn_impl=impl)
    model = get_model(CN.get_smoke_config(VLM, n_layers=n_layers,
                                          attn_impl=impl))
    params = port_tree(rparams)
    toks, ctx = tokens_of(model.cfg), ctx_of(model.cfg)
    want, _ = rmodel._forward(rparams, jnp.asarray(toks), jnp.asarray(ctx))
    got = model._forward(params, torch.from_numpy(toks),
                         torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1), "ctx": ctx}
    (rloss, rmet) = rmodel.loss_fn(rparams, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    loss, met = model.loss_fn(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert sorted(met) == sorted(rmet)
    for k in met:
        assert float(met[k]) == pytest.approx(float(rmet[k]), abs=LOSS_TOL)
    assert float(loss) == pytest.approx(float(rloss), abs=LOSS_TOL)


def _prefill_and_decode(rmodel, rparams, model, params, toks, ctx, S):
    """Prefill of ``S`` tokens into a cache of ``S + 4``, then two decode
    steps teacher-forced with the reference's greedy tokens; each step's
    logits compared; returns both final caches."""
    rl, rc = rmodel.prefill(rparams, jnp.asarray(toks), S + 4,
                            ctx=jnp.asarray(ctx))
    gl, gc = model.prefill(params, torch.from_numpy(toks), S + 4,
                           ctx=torch.from_numpy(ctx))
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    for step in range(2):
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(np.int32)
        rl, rc = rmodel.decode_step(rparams, jnp.asarray(nxt), rc,
                                    jnp.int32(S + step))
        gl, gc2 = model.decode_step(params, torch.from_numpy(nxt), gc,
                                    S + step)
        assert gc2 is gc
        np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    return gc, rc


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_layers", [5, 7])
def test_vlm_prefill_and_two_decode_steps_match_reference(n_layers, impl):
    """The cross K/V are written into the cache at prefill and read from
    it at decode: the logits and the whole cache after the last step equal
    the reference's."""
    rmodel, rparams = reference(VLM, n_layers=n_layers, attn_impl=impl)
    model = get_model(CN.get_smoke_config(VLM, n_layers=n_layers,
                                          attn_impl=impl))
    toks, ctx = tokens_of(model.cfg, S=12), ctx_of(model.cfg)
    gc, rc = _prefill_and_decode(rmodel, rparams, model,
                                 port_tree(rparams), toks, ctx, 12)
    assert_trees_close(gc, rc)
    cross = gc["stage0"]["cross"][0]
    assert tuple(cross.shape) == (1, 2, 9, 2, 16) and cross.abs().max() > 0


def test_vlm_prefill_without_ctx_attends_the_zero_cache():
    rmodel, rparams = reference(VLM)
    model = get_model(CN.get_smoke_config(VLM))
    toks = tokens_of(model.cfg, S=8)
    rl, _ = rmodel.prefill(rparams, jnp.asarray(toks), 10)
    gl, gc = model.prefill(port_tree(rparams), torch.from_numpy(toks), 10)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    assert not gc["stage0"]["cross"][0].any()


# ---------------------------------------------------------------- EncDec

def test_encdec_tree_and_cache_equal_reference():
    rmodel, rparams = reference(AUDIO)
    model = get_model(CN.get_smoke_config(AUDIO))
    assert isinstance(model, EncDec)
    got = [(p, tuple(t.shape)) for p, t in flat(model.init(0, "cpu"))]
    assert got == [(p, t.shape) for p, t in flat(rparams)]
    want = rmodel.init_cache(2, 10)
    cache = model.init_cache(2, 10, "cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in flat(cache)] == \
        [(p, w.shape, torch.float32) for p, w in flat(want)]
    assert tuple(cache[1][0].shape) == (2, 2, 12, 2, 16)


def test_encdec_encode_matches_reference():
    rmodel, rparams = reference(AUDIO)
    model = get_model(CN.get_smoke_config(AUDIO))
    frames = ctx_of(model.cfg, S=0)
    want = rmodel.encode(rparams, jnp.asarray(frames))
    got = model.encode(port_tree(rparams), torch.from_numpy(frames))
    assert tuple(got.shape) == want.shape == (2, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encdec_forward_and_loss_match_reference(impl):
    rmodel, rparams = reference(AUDIO, attn_impl=impl)
    model = get_model(CN.get_smoke_config(AUDIO, attn_impl=impl))
    params = port_tree(rparams)
    toks, frames = tokens_of(model.cfg), ctx_of(model.cfg)
    enc = rmodel.encode(rparams, jnp.asarray(frames))
    want, _ = rmodel._decode(rparams, jnp.asarray(toks), enc)
    got = model._forward(params, torch.from_numpy(toks),
                         torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "frames": frames}
    rloss, rmet = rmodel.loss_fn(rparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    loss, met = model.loss_fn(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert sorted(met) == sorted(rmet) == ["ce_loss"]
    assert float(loss) == pytest.approx(float(rloss), abs=LOSS_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encdec_prefill_and_two_decode_steps_match_reference(impl):
    """Frames of ``n_ctx`` (12): the cross cache is written at prefill and
    read at decode; logits and both caches equal the reference's."""
    rmodel, rparams = reference(AUDIO, attn_impl=impl)
    model = get_model(CN.get_smoke_config(AUDIO, attn_impl=impl))
    toks, frames = tokens_of(model.cfg, S=10), ctx_of(model.cfg, S=0)
    gc, rc = _prefill_and_decode(rmodel, rparams, model,
                                 port_tree(rparams), toks, frames, 10)
    assert_trees_close(gc, rc)
    assert gc[1][0].abs().max() > 0


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_reference(arch):
    for get, rget in ((CN.get_smoke_config, RCN.get_smoke_config),
                      (CN.get_config, RCN.get_config)):
        cfg, rcfg = get(arch), rget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
    assert CN.get_config(arch).param_count() == {
        VLM: 87_666_794_496, AUDIO: 2_034_835_456}[arch]


def test_vlm_ten_layers_count():
    """The depth served on one card: two super blocks, 8 self and 2 cross
    layers."""
    cfg = CN.get_config(VLM, n_layers=10)
    assert get_model(cfg).plan == [("vlm_super", 2, 4)]
    assert cfg.param_count() == 10_657_898_496 == RCN.get_config(
        VLM, n_layers=10).param_count()


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step of the smoke model: the gradients
    within 1e-5 of their norm of the reference's ``jax.grad``, the loss
    within 1e-5, and the step's metrics against the reference's
    ``_grad_fn`` + ``apply_updates``."""
    rmodel, rparams = reference(arch)
    cfg = CN.get_smoke_config(arch)
    toks = tokens_of(cfg, B=4, S=16)
    key = "ctx" if cfg.family == "vlm" else "frames"
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             key: ctx_of(cfg, B=4)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss_fn,
                                            has_aux=True)(rparams, jb)
    params = trainer.trainable(port_tree(rparams))
    grads, loss, _ = trainer._grad_fn(get_model(cfg), 1)(params, tb)
    assert float(loss) == pytest.approx(float(rloss), abs=LOSS_TOL)
    assert rel_err(grads, port_tree(rgrads)) < GRAD_TOL
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    rcfg, ocfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    g, rl, rmet = ref_trainer._grad_fn(rmodel, 1)(rparams, jb)
    _, _, rom = ref_adamw.apply_updates(
        rcfg, rparams, g, ref_adamw.init_opt_state(rcfg, rparams))
    step = trainer.make_train_step(cfg, ocfg)
    new, _, met = step(params, adamw.init_opt_state(ocfg, params), tb)
    want = dict(rmet, **rom, loss=rl)
    assert sorted(met) == sorted(want)
    for k in met:
        assert float(met[k]) == pytest.approx(float(want[k]), rel=GRAD_TOL,
                                              abs=1e-5), k
    assert all(bool(torch.isfinite(t).all()) for t in common.tree_leaves(new))


@pytest.mark.parametrize("arch", ARCHS)
def test_data_pipeline_second_input(arch):
    """A VLM batch carries ``ctx [B, n_ctx, d_ctx]``, an audio batch
    ``frames [B, S // 4, d_model]``, both bf16, and the whole batch is a
    pure function of ``(seed, step)``."""
    cfg = CN.get_smoke_config(arch)
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, batch=3, seq_len=16,
                           seed=5, family=cfg.family, n_ctx=cfg.n_ctx,
                           d_ctx=cfg.d_ctx, d_model=cfg.d_model)
    b = data.synth_batch(dcfg, 2, "cpu")
    key, shape = (("ctx", (3, 9, 64)) if arch == VLM
                  else ("frames", (3, 4, 64)))
    assert sorted(b) == sorted(["tokens", "labels", key])
    assert tuple(b[key].shape) == shape and b[key].dtype == torch.bfloat16
    assert float(b[key].float().std()) == pytest.approx(1.0, abs=0.3)
    again = data.synth_batch(dcfg, 2, "cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    other = data.synth_batch(dcfg, 3, "cpu")
    assert not torch.equal(b[key], other[key])
    plain = data.synth_batch(dataclasses.replace(dcfg, family="dense"), 2,
                             "cpu")
    assert sorted(plain) == ["labels", "tokens"]
    assert torch.equal(plain["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_on_cpu(arch, tmp_path):
    """The launcher draws the second input, gives the VLM its ``ctx`` in
    the compute dtype, and trains: finite losses."""
    out = run_training(arch, steps=3, batch=2, seq=16, ckpt_every=0,
                       ckpt_dir=str(tmp_path), log_every=1, device="cpu")
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """``ServingEngine.generate`` with a ``ctx`` against the reference's
    engine on the same weights, prompts and ``ctx``: the same greedy
    tokens."""
    rmodel, rparams = reference(arch)
    cfg = CN.get_smoke_config(arch)
    toks, ctx = tokens_of(cfg, S=8), ctx_of(cfg, S=0)
    want = REngine(rmodel.cfg, RServe(batch=2, max_len=14),
                   params=rparams).generate(jnp.asarray(toks), 5,
                                            ctx=jnp.asarray(ctx))
    eng = ServingEngine(cfg, ServeConfig(batch=2, max_len=14),
                        params=port_tree(rparams), device="cpu")
    got = eng.generate(torch.from_numpy(toks), 5, ctx=torch.from_numpy(ctx))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.last_stats["logits_finite"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_on_cpu(arch, impl):
    out = run_serving(arch, batch=2, prompt_len=6, new_tokens=3, smoke=True,
                      attn_impl=impl, device="cpu")
    assert out["generated_shape"] == [2, 3]
    assert out["all_in_vocab"] and out["logits_finite"]
    assert out["n_params"] == CN.get_smoke_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` with ``ctx`` then ``make_serve_step`` at the
    prompt's end against the reference's engine (no mesh)."""
    rmodel, rparams = reference(arch)
    cfg = CN.get_smoke_config(arch)
    toks, ctx = tokens_of(cfg, S=10), ctx_of(cfg, S=0)
    reng = REngine(rmodel.cfg, RServe(batch=2, max_len=11), params=rparams)
    rl, rc = reng.prefill(jnp.asarray(toks), jnp.asarray(ctx))
    params = port_tree(rparams)
    gl, gc = make_prefill_step(cfg, 2, 11, device="cpu")(
        params, torch.from_numpy(toks), torch.from_numpy(ctx))
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(np.int32)
    rd, _ = reng.decode(jnp.asarray(nxt), rc, jnp.int32(10))
    gd, _ = make_serve_step(cfg, 2, 11, device="cpu")(
        params, torch.from_numpy(nxt), gc, 10)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=ATOL)


# ---------------------------------------------------------------- dry-run

SMOKE_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "head_dim", "cross_every", "n_ctx", "d_ctx",
                "n_enc_layers", "n_dec_layers")


@pytest.mark.parametrize("shape", list(CN.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell_at_smoke_widths(arch, shape):
    """Each shape's cell counted on the meta device at smoke widths (the
    shape's full batch and length): counted, with the ``ctx`` or
    ``frames`` in its argument bytes; ``long_500k`` a skip."""
    smoke = CN.get_smoke_config(arch)
    over = {f: getattr(smoke, f) for f in SMOKE_FIELDS}
    rec = dryrun.lower_cell(arch, shape, over)
    if shape == "long_500k":
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    spec = CN.SHAPES[shape]
    cfg = CN.get_config(arch, **over)
    ins = CN.input_specs(cfg, spec)
    second = ins.get("ctx", ins.get("batch", {}).get("ctx",
                                                     ins.get("batch", {}).get(
                                                         "frames")))
    if spec.kind != "decode":
        assert second is not None
        assert rec["memory"]["argument_size_in_bytes"] > \
            second.numel() * second.element_size()


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_ctx_of_another_dtype_is_refused(dtype):
    """The f32 smoke VLM takes ``ctx`` in f32 only: forward, loss and
    prefill raise ``TypeError`` naming both dtypes; the encoder-decoder
    casts its frames, as the reference does."""
    cfg = CN.get_smoke_config(VLM)
    model = get_model(cfg)
    params = model.init(0, "cpu")
    toks = torch.from_numpy(tokens_of(cfg, S=8))
    ctx = torch.from_numpy(ctx_of(cfg)).to(dtype)
    name = str(dtype)
    with pytest.raises(TypeError, match=f"{name}.*float32"):
        model._forward(params, toks, ctx)
    with pytest.raises(TypeError, match=name):
        model.loss_fn(params, {"tokens": toks, "labels": toks, "ctx": ctx})
    with pytest.raises(TypeError, match=name):
        model.prefill(params, toks, 10, ctx=ctx)
    with pytest.raises(ValueError, match="ctx"):
        model._forward(params, toks)
    audio = get_model(CN.get_smoke_config(AUDIO))
    ap = audio.init(0, "cpu")
    frames = torch.from_numpy(ctx_of(audio.cfg, S=0))
    got, _ = audio.prefill(ap, toks, 10, ctx=frames.to(dtype))
    want, _ = audio.prefill(ap, toks, 10, ctx=frames.to(dtype).float())
    assert torch.equal(got, want)


def test_encdec_prefill_without_ctx_is_refused():
    model = get_model(CN.get_smoke_config(AUDIO))
    params = model.init(0, "cpu")
    toks = torch.from_numpy(tokens_of(model.cfg, S=6))
    with pytest.raises(ValueError, match="frames"):
        model.prefill(params, toks, 8)
    with pytest.raises(ValueError, match="frames"):
        make_prefill_step(model.cfg, 2, 8, device="cpu")(params, toks)


@pytest.mark.parametrize("arch,overrides", [
    (VLM, dict(cross_every=1)), (VLM, dict(cross_every=0)),
    (VLM, dict(use_mla=True)),
    (AUDIO, dict(n_enc_layers=0)), (AUDIO, dict(n_dec_layers=0))])
def test_malformed_cross_configs_are_refused(arch, overrides):
    """Where the reference asserts (``cross_every > 1``, both stacks
    present) the port raises ``ValueError``; so it does for MLA in the VLM
    plan, whose latent cache the reference's super block cannot index."""
    with pytest.raises(ValueError):
        get_model(CN.get_smoke_config(arch, **overrides))
