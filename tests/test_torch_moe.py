"""The MoE family with MLA (``models/moe.py``, ``attention.apply_mla``, the
MoE layer plans, deepseek-v3-671b and llama4-maverick-400b-a17b) against
the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights come from the reference's
init through ``models.weights.from_reference``. The reference's routing
(``jax.lax.top_k``'s indices and ``_cummax``'s segment starts) is read
from its own calls, by wrapping those two functions while it runs.

Tolerances: routing (expert indices, capacity ranks, ``keep``) and the
capacity exact; f32 values of order one within ``ATOL = 1e-5``, the dense
twins' (the two frameworks sum in other orders); the smoke archs' loss,
its cross entropy and aux loss within 1e-5 and their gradients'
``global_norm(g_port - g_ref) / global_norm(g_ref)`` below 1e-5, as
``tests/test_torch_train.py`` holds the dense model's; parameter counts
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCN
from repro.data import pipeline as ref_data
from repro.models import attention as rattn
from repro.models import moe as rmoe
from repro.models.transformer import get_model as ref_get_model
from repro_torch import configs as CN
from repro_torch.launch.serve import run_serving
from repro_torch.models import attention, common, moe
from repro_torch.models.transformer import get_model
from repro_torch.models.weights import from_reference
from repro_torch.optim import adamw
from repro_torch.train import trainer

ATOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
MOE_ARCHS = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
D = 32


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


# ---------------------------------------------------------------- the layer

# name: (B, S, E, top_k, n_shared, router_bias, capacity_factor,
#        token_chunks, the capacity, zero router)
MOE_CASES = {
    "top1": (2, 16, 4, 1, 0, False, 1.25, 1, 10, False),
    "top8_shared": (2, 16, 16, 8, 1, False, 1.25, 1, 20, False),
    "two_shared": (2, 16, 8, 2, 2, False, 1.25, 1, 10, False),
    "router_bias": (2, 16, 8, 2, 1, True, 1.25, 1, 10, False),
    # 36 / 8 = 4.5 rounds half to even: 4, not 5; tokens drop
    "drop": (2, 18, 8, 1, 0, False, 1.0, 1, 4, False),
    # every score tied: the lower experts first, the rest dropped
    "ties": (2, 16, 8, 2, 0, False, 1.25, 1, 10, True),
    # T = 64 in 8 interleaved chunks of 8 tokens (>= 8 experts): each
    # chunk's capacity max(4, round(2.5)) = 4
    "chunks": (2, 32, 8, 2, 1, False, 1.25, 8, 4, False),
    # 8 tokens a chunk < 16 experts: dispatched whole
    "chunks_not_taken": (2, 32, 16, 2, 0, False, 1.25, 8, 10, False),
}


def moe_case(name):
    B, S, E, k, n_shared, bias, cf, chunks, cap, zero = MOE_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    rp, _ = rmoe.init_moe(jax.random.PRNGKey(len(name)), D, 24, E, n_shared,
                          24, jnp.float32)
    if zero:
        rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    rb = (rng.standard_normal(E).astype(np.float32) * 0.05 if bias
          else None)
    kw = dict(top_k=k, n_experts=E, capacity_factor=cf)
    return x, rp, rb, kw, chunks, cap


def reference_routing(monkeypatch, rp, xf, rb, kw):
    """The routing of the reference's ``_moe_tokens`` on tokens ``xf [T,
    D]``, run eagerly, read from its own ``top_k`` and ``_cummax``
    calls."""
    seen = {}
    top_k, cummax = jax.lax.top_k, rmoe._cummax

    def spy_top_k(x, k):
        out = top_k(x, k)
        seen["idx"] = np.asarray(out[1])
        return out

    def spy_cummax(x):
        out = cummax(x)
        seen["rank"] = np.arange(x.shape[0]) - np.asarray(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(rmoe, "_cummax", spy_cummax)
    rmoe._moe_tokens(rp, jnp.asarray(xf), router_bias=(
        None if rb is None else jnp.asarray(rb)), **kw)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_apply_moe_matches_reference(name, monkeypatch):
    x, rp, rb, kw, chunks, cap = moe_case(name)
    p = port_tree(rp)
    tb = None if rb is None else torch.from_numpy(rb)
    B, S, _ = x.shape
    T = B * S
    taken = chunks > 1 and T % chunks == 0 and T // chunks >= kw["n_experts"]
    # chunk i holds tokens i, i + c, ...: route each as the reference does
    parts = ([x.reshape(T // chunks, chunks, D)[:, i] for i in range(chunks)]
             if taken else [x.reshape(T, D)])
    dropped = 0
    for xf in parts:
        want = reference_routing(monkeypatch, rp, xf, rb, kw)
        got = moe.route(p, torch.from_numpy(np.ascontiguousarray(xf)),
                        router_bias=tb, **kw)
        assert got["cap"] == cap
        np.testing.assert_array_equal(got["idx"].numpy(), want["idx"])
        np.testing.assert_array_equal(got["rank"].numpy(), want["rank"])
        np.testing.assert_array_equal(got["keep"].numpy(),
                                      want["rank"] < cap)
        dropped += int((~got["keep"]).sum())
    if name in ("drop", "ties"):
        assert dropped > 0
    if name == "ties":
        assert (want["idx"] == np.arange(kw["top_k"])).all()

    wy, waux = rmoe.apply_moe(rp, jnp.asarray(x), token_chunks=chunks,
                              router_bias=None if rb is None
                              else jnp.asarray(rb), **kw)
    gy, gaux = moe.apply_moe(p, torch.from_numpy(x), token_chunks=chunks,
                             router_bias=tb, **kw)
    assert tuple(gy.shape) == wy.shape
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=ATOL)
    assert sorted(gaux) == sorted(waux)
    for k in waux:
        assert float(gaux[k]) == pytest.approx(float(waux[k]), abs=ATOL), k
    assert (float(gaux["dropped_fraction"]) > 0) == (dropped > 0)


def test_init_moe_leaves_equal_reference_shapes():
    want, want_axes = rmoe.init_moe(jax.random.PRNGKey(0), D, 24, 8, 1, 24,
                                    jnp.float32)
    got, axes = moe.init_moe(torch.Generator().manual_seed(0), D, 24, 8, 1,
                             24, torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    assert axes == want_axes
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


def test_by_slice_draws_each_slice_as_its_own_leaf():
    """``Builder.dense(by_slice=True)`` (the experts' matrices) draws one
    ``shape[0]`` slice at a time, cast to the parameter dtype: the slices
    one ``randn`` each would give, in order."""
    b = common.Builder(torch.Generator().manual_seed(3), torch.bfloat16,
                       "cpu")
    b.dense("w", (4, 5, 3), ("experts", "embed", "mlp"), by_slice=True)
    g = torch.Generator().manual_seed(3)
    want = torch.stack([(torch.randn((5, 3), generator=g) * 0.5).to(
        torch.bfloat16) for _ in range(4)])
    params, axes = b.done()
    assert torch.equal(params["w"], want)
    assert axes == {"w": ("experts", "embed", "mlp")}


def test_stack_of_one_block_is_a_view():
    """A stage of one block (maverick's 37 GB super block at n_layers=2)
    is that block's leaves with a new axis, not a copy."""
    block = {}

    def one(g):
        block["a"] = torch.randn((3, 2), generator=g)
        return dict(block), {"a": ("embed", "mlp")}

    got, axes = common.stack_layers(torch.Generator().manual_seed(1), 1, one)
    assert axes == {"a": ("layers", "embed", "mlp")}
    assert got["a"].shape == (1, 3, 2)
    assert got["a"].data_ptr() == block["a"].data_ptr()
    assert torch.equal(got["a"][0], block["a"])


# ---------------------------------------------------------------- MLA

MLA = dict(d_nope=16, d_rope=8, d_v=16, kv_rank=32)


def mla_case(seed=0, B=2, S=8):
    rp, _ = rattn.init_mla(jax.random.PRNGKey(seed), 64, 4, q_rank=48,
                           dtype=jnp.float32, **MLA)
    x = np.random.default_rng(seed).standard_normal((B, S, 64)).astype(
        np.float32)
    return rp, x


def test_sdpa_output_takes_v_width():
    """q and k of 24, v of 16 (MLA's shapes): the plain path's output is
    [B, S, H, 16] and equals the reference's; the flash route refuses."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 10, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    want = rattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    got = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=True)
    assert tuple(got.shape) == want.shape == (2, 10, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="24 and 16"):
        attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                       causal=True, impl="flash")


@pytest.mark.parametrize("absorbed", [False, True])
def test_apply_mla_without_cache_matches_reference(absorbed):
    rp, x = mla_case(1, S=12)
    pos = np.arange(12)
    want, wc = rattn.apply_mla(rp, jnp.asarray(x), positions=jnp.asarray(pos),
                               absorbed=absorbed, **MLA)
    got, gc = attention.apply_mla(port_tree(rp), torch.from_numpy(x),
                                  positions=torch.from_numpy(pos),
                                  absorbed=absorbed, **MLA)
    assert wc is None and gc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("absorbed", [False, True])
def test_apply_mla_with_cache_matches_reference(absorbed):
    """A prefill of 8 into a latent cache of 12, then two decode steps:
    outputs and the cache (written in place in the port) equal the
    reference's."""
    rp, x = mla_case(2, S=10)
    p = port_tree(rp)
    B, Smax = x.shape[0], 12
    wcache = (jnp.zeros((B, Smax, MLA["kv_rank"])),
              jnp.zeros((B, Smax, MLA["d_rope"])))
    gcache = tuple(torch.zeros(c.shape) for c in wcache)
    for start, stop in ((0, 8), (8, 9), (9, 10)):
        pos = np.arange(start, stop)
        want, wcache = rattn.apply_mla(
            rp, jnp.asarray(x[:, start:stop]), positions=jnp.asarray(pos),
            cache=wcache, cache_pos=jnp.int32(start), absorbed=absorbed,
            **MLA)
        got, out_cache = attention.apply_mla(
            p, torch.from_numpy(x[:, start:stop]),
            positions=torch.from_numpy(pos), cache=gcache, cache_pos=start,
            absorbed=absorbed, **MLA)
        assert out_cache is gcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        for g, w in zip(gcache, wcache):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ---------------------------------------------------------------- the archs

def reference(arch, **overrides):
    cfg = dataclasses.replace(RCN.get_smoke_config(arch), **overrides)
    model = ref_get_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))[0]


ARCH_VARIANTS = [("deepseek-v3-671b", {}),
                 ("deepseek-v3-671b", {"mla_absorbed": True}),
                 ("llama4-maverick-400b-a17b", {}),
                 ("llama4-maverick-400b-a17b", {"attn_impl": "flash"})]


def test_smoke_plans_equal_reference():
    for arch in MOE_ARCHS:
        assert get_model(CN.get_smoke_config(arch)).plan == \
            ref_get_model(RCN.get_smoke_config(arch)).plan
    assert get_model(CN.get_smoke_config(MOE_ARCHS[0])).plan == \
        [("dense", 1, 0), ("moe", 3, 0)]
    assert get_model(CN.get_smoke_config(MOE_ARCHS[1])).plan == \
        [("moe_super", 2, 1)]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn``'s total, cross entropy and summed load-balance loss, and
    the gradients of the total, of the f32 smoke model."""
    rmodel, rparams = reference(arch)
    dcfg = ref_data.DataConfig(vocab_size=rmodel.cfg.vocab_size, batch=4,
                               seq_len=32)
    batch = ref_data.synth_batch(dcfg, 0)
    (rloss, rmet), rgrads = jax.value_and_grad(
        rmodel.loss_fn, has_aux=True)(rparams, batch)
    params = trainer.trainable(port_tree(rparams))
    grads, loss, met = trainer._grad_fn(get_model(CN.get_smoke_config(arch)),
                                        1)(params, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert sorted(met) == sorted(rmet) == ["aux_loss", "ce_loss"]
    assert float(met["aux_loss"]) > 0
    for k in met:
        assert float(met[k]) == pytest.approx(float(rmet[k]), abs=LOSS_TOL)
    assert float(loss) == pytest.approx(float(rloss), abs=LOSS_TOL)
    assert rel_err(grads, port_tree(rgrads)) < GRAD_TOL
    router = [g for path, g in common.tree_items(grads) if "router" in path]
    assert router and all(float(g.abs().max()) > 0 for g in router)


@pytest.mark.parametrize("arch,overrides", ARCH_VARIANTS)
def test_prefill_and_two_decode_steps_match_reference(arch, overrides):
    """The smoke model's prefill of 2 x 24 tokens into a cache of 28, then
    two greedy decode steps (deepseek with and without ``mla_absorbed``,
    maverick through the flash route, the plain version on the CPU, and
    the plain one): each step's logits, and the cache after the last."""
    rmodel, rparams = reference(arch, **{
        k: v for k, v in overrides.items() if k != "attn_impl"})
    model = get_model(CN.get_smoke_config(arch, **overrides))
    params = port_tree(rparams)
    toks = np.random.default_rng(7).integers(
        0, rmodel.cfg.vocab_size, (2, 24)).astype(np.int32)
    rl, rc = rmodel.prefill(rparams, jnp.asarray(toks), 28)
    gl, gc = model.prefill(params, torch.from_numpy(toks), 28)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    for step in range(2):
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None].astype(np.int32)
        rl, rc = rmodel.decode_step(rparams, jnp.asarray(nxt), rc,
                                    jnp.int32(24 + step))
        gl, gc = model.decode_step(params, torch.from_numpy(nxt), gc,
                                   24 + step)
        np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=ATOL)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(rc)]
    got = [t for _, t in _cache_items(gc)]
    assert [t.shape for t in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def _cache_items(tree, prefix=()):
    """Leaves of a cache (dicts and tuples), keys sorted, as JAX's tree
    functions see them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_items(tree[k], prefix + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _cache_items(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_counts_equal_reference(arch):
    """Full and smoke configs; the full ones counted on the meta device."""
    for get, rget in ((CN.get_smoke_config, RCN.get_smoke_config),
                      (CN.get_config, RCN.get_config)):
        cfg, rcfg = get(arch), rget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()
    full = CN.get_config(arch)
    assert full.param_count() == {"deepseek-v3-671b": 671_026_404_352,
                                  "llama4-maverick-400b-a17b":
                                  400_711_848_960}[arch]
    if arch == "deepseek-v3-671b":
        assert 37e9 < full.active_param_count() < 38e9


@pytest.mark.parametrize("arch,n_layers,want", [
    ("deepseek-v3-671b", 4, 15_111_101_440),
    ("llama4-maverick-400b-a17b", 2, 18_679_096_320)])
def test_reduced_depth_counts(arch, n_layers, want):
    """The depths served on one card: deepseek's 3 dense + 1 MoE layers,
    maverick's one super block."""
    cfg = CN.get_config(arch, n_layers=n_layers)
    assert cfg.param_count() == want == RCN.get_config(
        arch, n_layers=n_layers).param_count()


# ---------------------------------------------------------------- refusals

def test_mla_under_flash_is_refused_in_both_packages():
    """The reference's kernel takes one head dim for q, k and v and fails
    on MLA's; the port refuses at ``get_model``, naming both widths."""
    rmodel, rparams = reference("deepseek-v3-671b", attn_impl="flash")
    toks = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(ValueError):
        rmodel.prefill(rparams, toks, 8)
    with pytest.raises(ValueError, match="192.*128"):
        get_model(CN.get_config("deepseek-v3-671b", attn_impl="flash"))
    with pytest.raises(ValueError, match="24.*16"):
        get_model(CN.get_smoke_config("deepseek-v3-671b",
                                      attn_impl="flash"))
    # the serving launcher's default is flash: deepseek is refused, and
    # served on the plain route
    kw = dict(batch=1, prompt_len=6, new_tokens=2, smoke=True, device="cpu")
    with pytest.raises(ValueError, match="flash"):
        run_serving("deepseek-v3-671b", **kw)
    out = run_serving("deepseek-v3-671b", attn_impl="xla", **kw)
    assert out["all_in_vocab"] and out["logits_finite"]
    out = run_serving("llama4-maverick-400b-a17b", **kw)
    assert out["all_in_vocab"] and out["logits_finite"]


@pytest.mark.parametrize("overrides", [
    dict(family="moe", n_experts=4), dict(use_mla=True),
    dict(family="dense", n_experts=2)])
def test_formerly_refused_models_build_and_train(overrides):
    """The MoE and MLA overrides of the smoke llama that the port refused
    before: built, the MoE plan taken wherever there are experts, and one
    loss with its gradients finite."""
    cfg = CN.get_smoke_config("llama3.2-1b", **overrides)
    model = get_model(cfg)
    assert model.plan == ref_get_model(dataclasses.replace(
        RCN.get_smoke_config("llama3.2-1b"), **overrides)).plan
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    params = trainer.trainable(model.init(0, "cpu"))
    grads, loss, met = trainer._grad_fn(model, 1)(
        params, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(loss))
    assert (float(met["aux_loss"]) > 0) == (cfg.n_experts > 0)
    assert all(bool(torch.isfinite(g).all())
               for g in common.tree_leaves(grads))
