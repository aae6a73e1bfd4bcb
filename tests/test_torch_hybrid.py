"""The port's hybrid model (zamba2) against the reference's, on the CPU.

``zamba2-1.2b``'s smoke config (5 Mamba blocks, the shared attention block
after every 2, width 64, chunk 8) in f32 with the reference's weights from
``init(PRNGKey(0))``, carried into the port by ``weights.from_reference``.
Tokens are made with numpy from a seed. The loss (about 5) agrees within
1e-5 under both ``ssm_impl`` values (the reference's ``mamba_kernel`` runs
its Pallas kernel in interpret mode; the port's, on the CPU, the kernel's
plain version); the prefill and decode logits (|logit| below 1) within
1e-4, the summation orders of two frameworks over 5 blocks and 3 attention
applications, and the caches within 1e-4 plus 1e-5 of each leaf's largest
value; greedy
generation gives the reference's tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import get_model as jget_model
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.models import weights
from repro_torch.models.transformer import HybridSSM, get_model
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCH = "zamba2-1.2b"
B, S = 2, 16
LOSS_ATOL = 1e-5
LOGIT_ATOL = 1e-4
# the SSM states reach 700 in magnitude (random A near 0 barely decays), and
# an entry that cancels to near 0 keeps the f32 rounding of the large
# terms: each leaf is held within 1e-4 + 1e-5 of its largest |value|
# (9e-7 of it seen)
CACHE_RTOL = 1e-5
N_PARAMS = 1_170_396_032     # the reference's full config


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's f32 smoke weights as a numpy tree."""
    params, _ = jget_model(jconfigs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def pair(**kw):
    """(reference model, port model) of the smoke config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)
    return jget_model(jcfg), get_model(configs.get_smoke_config(ARCH, **kw))


def tokens(seed, length=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, (B, length)).astype(np.int32)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol)


def test_config_mirrors_reference():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        got = dataclasses.asdict(getattr(configs, get)(ARCH))
        assert got == want, get


def test_full_config_shapes_match_reference():
    """Every leaf of the full-width tree has the reference's shape (so
    ``from_reference`` copies with no transposes), and the count is the
    reference's; shapes only, nothing allocated."""
    cfg = configs.get_config(ARCH)
    jm = jget_model(jconfigs.get_config(ARCH))
    want = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    got = HybridSSM(cfg).init(0, device="meta")
    leaves = jax.tree_util.tree_leaves_with_path(want)
    n = 0
    for path, a in leaves:
        x = got
        for key in path:
            x = x[key.key]
        assert tuple(x.shape) == a.shape, path
        assert x.dtype == torch.bfloat16
        n += x.numel()
    assert n == N_PARAMS
    assert tuple(got["supers"]["mamba"]["w_in"].shape) == (6, 6, 2048, 8384)
    assert tuple(got["tail"]["w_in"].shape) == (2, 2048, 8384)


def test_from_reference_copies_the_hybrid_tree(ref_params):
    port = weights.from_reference(ref_params, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(ref_params):
        x = port
        for key in path:
            x = x[key.key]
        assert np.array_equal(x.numpy(), a), path


@pytest.mark.parametrize("impl", ["xla", "mamba_kernel"])
def test_loss_matches_reference(ref_params, impl):
    jm, tm = pair(ssm_impl=impl)
    toks, labels = tokens(1), tokens(2)
    want, jaux = jm.loss_fn(jax.tree_util.tree_map(jnp.asarray, ref_params),
                            {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
    got, aux = tm.loss_fn(weights.from_reference(ref_params, device="cpu"),
                          {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.dim() == 0
    close(got, want, LOSS_ATOL)
    assert aux["ce_loss"] is got


def test_prefill_and_two_decode_steps_match_reference(ref_params):
    jm, tm = pair()
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    tp = weights.from_reference(ref_params, device="cpu")
    toks = tokens(3, 13)     # ragged against the chunk of 8
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=16)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=16)
    close(tl, jl, LOGIT_ATOL)
    for path, a in jax.tree_util.tree_leaves_with_path(jc):
        x = tc
        for key in path:
            x = x[key.key if hasattr(key, "key") else key.idx]
        assert x.dtype == (torch.float32 if a.dtype == jnp.float32
                           else torch.bfloat16)
        close(x, a, LOGIT_ATOL + CACHE_RTOL * float(np.abs(a).max()))
    for i in range(2):
        tok = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(13 + i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, 13 + i)
        close(tl, jl, LOGIT_ATOL)


def test_generate_gives_reference_tokens(ref_params):
    jm, tm = pair()
    n_new = 6
    jeng = JServingEngine(jm.cfg, JServeConfig(batch=B, max_len=S + n_new + 1),
                          params=jax.tree_util.tree_map(jnp.asarray,
                                                        ref_params))
    teng = ServingEngine(tm.cfg, ServeConfig(batch=B, max_len=S + n_new + 1),
                         params=weights.from_reference(ref_params,
                                                       device="cpu"),
                         device="cpu")
    toks = tokens(4)
    want = jeng.generate(jnp.asarray(toks), n_new)
    got = teng.generate(torch.from_numpy(toks), n_new)
    assert got.shape == (B, n_new) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert teng.last_stats["logits_finite"]


def test_prefill_decode_matches_own_loss_path(ref_params):
    """Teacher-forced decode from a prefill reproduces the last logits of
    the full-sequence forward (the loss path, through the kernel's plain
    version), within 1e-4."""
    _, tm = pair(ssm_impl="mamba_kernel")
    tp = weights.from_reference(ref_params, device="cpu")
    toks = torch.from_numpy(tokens(5))
    full = tm._forward(tp, toks)
    lp, cache = tm.prefill(tp, toks[:, :S - 2], max_len=S)
    close(lp[:, 0], full[:, S - 3].numpy(), LOGIT_ATOL)
    _, cache = tm.decode_step(tp, toks[:, S - 2:S - 1], cache, S - 2)
    l2, _ = tm.decode_step(tp, toks[:, S - 1:S], cache, S - 1)
    close(l2[:, 0], full[:, -1].numpy(), LOGIT_ATOL)


@pytest.mark.parametrize("length", [6, 8, 13, 16])
def test_prefill_takes_the_kernel_only_where_it_accepts_the_prompt(
        ref_params, monkeypatch, length):
    """Under ``ssm_impl="mamba_kernel"`` the prefill starts its Mamba blocks
    from no state, and so reaches ``mamba2_scan``, exactly where the CUDA
    kernel takes the prompt (``kernel_takes``: 8 and 16 tokens at the
    smoke chunk of 8); 6 and 13 read the new cache's zeros and run the
    plain scan. Either way the logits and the states are the plain route's
    within 1e-4."""
    from repro_torch.kernels.mamba2_scan import kernel_takes
    from repro_torch.models import ssm
    calls = []
    real = ssm.mamba2_scan
    monkeypatch.setattr(ssm, "mamba2_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tm = pair(ssm_impl="mamba_kernel")
    _, plain = pair()
    tp = weights.from_reference(ref_params, device="cpu")
    toks = torch.from_numpy(tokens(6, length))
    got, gc = tm.prefill(tp, toks, max_len=S + 2)
    c = tm.cfg
    takes = kernel_takes(c.cdt, length, c.ssm_head_dim, c.ssm_state,
                         c.ssd_chunk)
    assert takes == (length % 8 == 0)
    assert len(calls) == (c.n_layers if takes else 0)
    want, wc = plain.prefill(tp, toks, max_len=S + 2)
    close(got, want.numpy(), LOGIT_ATOL)
    for k in ("conv", "ssm"):
        a = wc["states"]["supers"]["mamba"][k]
        close(gc["states"]["supers"]["mamba"][k], a.numpy(),
              LOGIT_ATOL + CACHE_RTOL * float(a.abs().max()))


# ------------------------------------------- experts and MLA in the hybrid

MLA_DIMS = dict(q_rank=32, kv_rank=16, d_nope=8, d_rope=8, d_v=16)
GRAD_TOL = 1e-4      # the hybrid's gradients, as in test_torch_train.py


def ref_pair_params(**kw):
    """(reference model, port model, the reference's weights of that
    config as numpy)."""
    jm, tm = pair(**kw)
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jax.tree_util.tree_map(np.asarray, params)


def test_experts_leave_the_shared_block_dense_as_the_reference():
    """``n_experts=4``: the shared block is built dense (the reference's
    ``moe_ffn=False``), and ``loss_fn``, ``prefill`` and two
    ``decode_step`` calls equal the reference's."""
    jm, tm, rp = ref_pair_params(n_experts=4)
    assert sorted(rp["shared_attn"]["ffn"]) == ["w_down", "w_gate", "w_up"]
    _, axes = tm.init(0, "cpu", with_axes=True)
    assert axes == jm.init(jax.random.PRNGKey(0))[1]
    jp = jax.tree_util.tree_map(jnp.asarray, rp)
    tp = weights.from_reference(rp, device="cpu")
    toks, labels = tokens(6), tokens(7)
    want, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    got, _ = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    close(got, want, LOSS_ATOL)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :11]), max_len=16)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :11]), max_len=16)
    close(tl, jl, LOGIT_ATOL)
    for i in range(2):
        tok = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(11 + i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, 11 + i)
        close(tl, jl, LOGIT_ATOL)


def test_mla_hybrid_trains_as_the_reference_and_refuses_prefill():
    """``use_mla=True``: the loss, the gradients and one training step's
    metrics equal the reference's (``_grad_fn`` + ``apply_updates`` under
    ``jax.jit``); the prefill, which the reference cannot run (it writes
    MLA's latent into the GQA-shaped shared cache), raises ``ValueError``
    naming that failure."""
    from repro.optim import adamw as ref_adamw
    from repro.train import trainer as ref_trainer
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    jm, tm, rp = ref_pair_params(use_mla=True, **MLA_DIMS)
    assert sorted(rp["shared_attn"]["attn"]) == [
        "kv_norm", "q_norm", "wkv_a", "wkv_b", "wo", "wq_a", "wq_b"]
    jp = jax.tree_util.tree_map(jnp.asarray, rp)
    toks, labels = tokens(8), tokens(9)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    rcfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rgrads_of = ref_trainer._grad_fn(jm, 1)

    @jax.jit
    def rstep(p, o, b):
        g, loss, met = rgrads_of(p, b)
        p, o, om = ref_adamw.apply_updates(rcfg, p, g, o)
        return g, p, dict(met, **om, loss=loss)

    rgrads, rnew, rmet = rstep(jp, ref_adamw.init_opt_state(rcfg, jp), jb)
    params = trainer.trainable(weights.from_reference(rp, device="cpu"))
    grads, loss, _ = trainer._grad_fn(tm, 1)(params, tb)
    close(loss, rmet["loss"], LOSS_ATOL)
    want_g = weights.from_reference(
        jax.tree_util.tree_map(np.asarray, rgrads), device="cpu")
    diff = tree_map(lambda a, b: a - b, grads, want_g)
    assert float(adamw.global_norm(diff) / adamw.global_norm(want_g)) \
        < GRAD_TOL
    step = trainer.make_train_step(tm.cfg, cfg)
    new, _, met = step(params, adamw.init_opt_state(cfg, params), tb)
    assert sorted(met) == sorted(rmet)
    for k in met:
        assert float(met[k]) == pytest.approx(float(rmet[k]), rel=GRAD_TOL,
                                              abs=LOSS_ATOL), k
    # AdamW's first step moves each parameter by at most lr (2 lr where a
    # rounding-level gradient's sign flips between the two frameworks)
    want_p = weights.from_reference(
        jax.tree_util.tree_map(np.asarray, rnew), device="cpu")
    for a, b in zip(tree_leaves(new), tree_leaves(want_p)):
        assert float((a.detach() - b).abs().max()) <= 2 * kw["lr"] + 1e-6
    with pytest.raises(ValueError, match="dynamic_update_slice"):
        tm.prefill(tp := weights.from_reference(rp, device="cpu"),
                   torch.from_numpy(toks), max_len=16)
    with pytest.raises(ValueError, match="dynamic_update_slice"):
        tm.decode_step(tp, torch.from_numpy(toks[:, :1]),
                       tm.init_cache(B, 16, "cpu"), 0)
    with pytest.raises(Exception):      # the reference's own failure
        jm.prefill(jp, jnp.asarray(toks), max_len=16)
