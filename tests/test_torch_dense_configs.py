"""The three remaining dense configs (granite-3-8b, stablelm-3b,
granite-20b), the gelu MLP, the padded vocab, the flash wrapper's padded
head dim, the configs' input and parameter specs and the serving steps,
against the JAX package, on the CPU.

Inputs and weights are made with numpy (or the reference's init) from a
seed and handed to both packages. Tolerances: parameter counts, specs and
the padded vocab's mask exact; f32 values of order one within 1e-5 (the
two frameworks sum in other orders); the flash wrapper's padded path within
1e-6 of the plain attention at the true head dim.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as RCN
from repro.data import pipeline as ref_data
from repro.models import common as jcommon
from repro.models.transformer import get_model as ref_get_model
from repro_torch import configs as CN
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import common
from repro_torch.models.transformer import get_model
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.train import trainer

NEW = ("granite-3-8b", "stablelm-3b", "granite-20b")
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tree(tree):
    return from_reference(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def reference(cfg):
    model = ref_get_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))[0]


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", NEW)
def test_full_width_param_count_equals_reference(arch):
    want = RCN.get_config(arch).param_count()
    cfg = CN.get_config(arch)
    assert cfg.param_count() == want
    assert cfg.active_param_count() == want


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(RCN, get)(arch))
        assert dataclasses.asdict(getattr(CN, get)(arch)) == want


def test_granite_vocab_is_padded():
    cfg = CN.get_config("granite-3-8b")
    assert cfg.vocab_size == 49155
    assert common.padded_vocab(cfg.vocab_size) == 49408
    params = get_model(cfg).init(0, device="meta")
    assert params["lm_head"].shape == (4096, 49408)
    assert params["embed"].shape == (49155, 4096)


# ---------------------------------------------------------------- gelu MLP

def test_gelu_mlp_matches_reference_and_is_the_tanh_form():
    rng = np.random.default_rng(5)
    x, wu, bu, wd, bd = (rng.standard_normal(s).astype(np.float32) * 0.5
                         for s in ((2, 4, 32), (32, 48), (48,), (48, 32),
                                   (32,)))
    want = jcommon.gelu_mlp(*(jnp.asarray(a) for a in (x, wu, bu, wd, bd)))
    tx, twu, tbu, twd, tbd = (torch.from_numpy(a) for a in (x, wu, bu, wd,
                                                            bd))
    got = common.gelu_mlp(tx, twu, tbu, twd, tbd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    h = tx @ twu + tbu
    erf = F.gelu(h, approximate="none") @ twd + tbd
    # the exact-erf gelu is another function: it differs by far more
    assert float((got - erf).abs().max()) > 1e-4


def test_init_gelu_mlp_keys_shapes_and_zero_biases():
    want = jcommon.init_gelu_mlp(jax.random.PRNGKey(0), 16, 40,
                                 jnp.float32)[0]
    got = common.init_gelu_mlp(torch.Generator().manual_seed(0), 16, 40,
                               torch.float32, "cpu")
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
    assert not got["b_up"].any() and not got["b_down"].any()
    assert got["w_up"].std() > 0


def test_stack_layers_draws_as_a_stack_of_blocks():
    """The stacked build holds the blocks that drawing them one by one and
    stacking gives, bit for bit."""
    def one(g):
        return {"a": torch.randn((3, 2), generator=g),
                "b": {"c": torch.randn(4, generator=g).to(torch.bfloat16)}}

    got = common.stack_layers(torch.Generator().manual_seed(7), 5, one)
    g = torch.Generator().manual_seed(7)
    blocks = [one(g) for _ in range(5)]
    assert torch.equal(got["a"], torch.stack([b["a"] for b in blocks]))
    assert torch.equal(got["b"]["c"],
                       torch.stack([b["b"]["c"] for b in blocks]))


# ---------------------------------------------------------------- f32 twins

@pytest.mark.parametrize("arch", NEW)
def test_smoke_forward_matches_reference(arch):
    rmodel, rparams = reference(RCN.get_smoke_config(arch))
    tokens = np.random.default_rng(3).integers(
        0, rmodel.cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = rmodel._forward(rparams, jnp.asarray(tokens))
    got = get_model(CN.get_smoke_config(arch))._forward(
        port_tree(rparams), torch.from_numpy(tokens))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_train_step_loss_matches_reference(arch):
    """The loss and gradients of one step (the gelu biases' gradients
    included)."""
    cfg = RCN.get_smoke_config(arch)
    rmodel, rparams = reference(cfg)
    dcfg = ref_data.DataConfig(vocab_size=cfg.vocab_size, batch=4,
                               seq_len=32)
    batch = ref_data.synth_batch(dcfg, 0)
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        rparams, batch)
    params = trainer.trainable(port_tree(rparams))
    grads, loss, _ = trainer._grad_fn(get_model(CN.get_smoke_config(arch)),
                                      1)(params, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(rloss), abs=ATOL)
    want = port_tree(rgrads)
    for (path, g), (_, w) in zip(common.tree_items(grads),
                                 common.tree_items(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL,
                                   err_msg=str(path))
    if cfg.mlp_type == "gelu":
        assert float(grads["stage0"]["ffn"]["b_up"].abs().max()) > 0


def test_padded_vocab_mask_matches_reference():
    """granite-3-8b's vocab, 49,155 padded to 49,408, on the smoke widths:
    the padded columns are -1e30 and the loss equals the reference's."""
    cfg = dataclasses.replace(RCN.get_smoke_config("granite-3-8b"),
                              vocab_size=49155)
    rmodel, rparams = reference(cfg)
    assert rparams["lm_head"].shape[-1] == 49408
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 49155, (2, 8)).astype(np.int32)
    labels = rng.integers(0, 49155, (2, 8)).astype(np.int32)
    want, _ = rmodel._forward(rparams, jnp.asarray(tokens))
    model = get_model(CN.get_smoke_config("granite-3-8b", vocab_size=49155))
    params = port_tree(rparams)
    got = model._forward(params, torch.from_numpy(tokens))
    assert bool((got[..., 49155:] == -1e30).all())
    np.testing.assert_allclose(got[..., :49155].numpy(),
                               np.asarray(want)[..., :49155], atol=ATOL)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    rloss, _ = rmodel.loss_fn(rparams, batch)
    loss, _ = model.loss_fn(params, {k: torch.from_numpy(np.array(v))
                                     for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(rloss), abs=ATOL)


# ---------------------------------------------------------------- flash D=80

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Hkv", [(80, 4), (80, 1), (48, 2), (16, 2)])
def test_flash_padded_head_dim_equals_plain(D, Hkv, causal):
    """A head dim the kernel takes only padded (stablelm-3b's 80, and
    multiples of 16 below 64) runs zero-padded to the kernel's next head
    dim with its own 1/sqrt(D) scale: the same attention as the plain
    version at D, within 1e-6 in f32."""
    assert fa.padded_head_dim(D) in fa.KERNEL_HEAD_DIMS
    rng = np.random.default_rng(D + Hkv)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, Hkv, D)).astype(
        np.float32)) for _ in range(2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before
    assert got.shape == q.shape and got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-6


def test_flash_head_dims_the_kernel_cannot_take():
    assert [fa.padded_head_dim(d) for d in (16, 64, 80, 96, 128)] == \
        [64, 64, 128, 128, 128]
    assert fa.padded_head_dim(72) is None and fa.padded_head_dim(144) is None


def test_stablelm_flash_serving_equals_plain_path():
    """The smoke stablelm-3b at its full head dim, 80, prefilled through
    the flash route (the padded path) and the plain one: equal logits."""
    out = {}
    for impl in ("flash", "xla"):
        cfg = CN.get_smoke_config("stablelm-3b", head_dim=80, attn_impl=impl)
        model = get_model(cfg)
        params = model.init(0, "cpu")
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))
        out[impl] = make_prefill_step(cfg, 2, 16, device="cpu")(
            params, tokens)[0]
    assert float((out["flash"] - out["xla"]).abs().max()) <= ATOL


# ---------------------------------------------------------------- specs

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", CN.ARCHS)
def test_param_and_input_specs_equal_reference(arch):
    """Shapes and dtypes of every parameter and every step input, for each
    shape the arch runs; the port's decode cache is its own
    ``init_cache(device="meta")``, whose leaves (written in place) are the
    reference's. The port's specs live on the meta device."""
    rcfg, cfg = RCN.get_config(arch), CN.get_config(arch)
    pshapes, axes = CN.param_specs(cfg)
    assert axes is None
    assert list(_flat(pshapes)) == list(_flat(RCN.param_specs(rcfg)[0]))
    assert all(t.device.type == "meta" for t in common.tree_leaves(pshapes))
    for name, spec in CN.SHAPES.items():
        if not CN.cell_supported(cfg.family, name)[0]:
            continue
        got = CN.input_specs(cfg, spec)
        want = RCN.input_specs(rcfg, RCN.SHAPES[name])
        assert list(_flat(got)) == list(_flat(want)), name


def test_shapes_equal_reference():
    assert CN.SHAPES == {k: CN.ShapeSpec(*v.__dict__.values())
                         for k, v in RCN.SHAPES.items()}
    for fam in ("dense", "hybrid", "ssm", "moe"):
        for name in CN.SHAPES:
            assert CN.cell_supported(fam, name) == RCN.cell_supported(fam,
                                                                      name)


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("arch", ["granite-20b", "zamba2-1.2b"])
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` then ``make_serve_step`` at the prompt's end
    against the reference's steps (no mesh: ``ServingEngine``'s jitted
    pair), f32 smoke models; the steps refuse other shapes."""
    from repro.serving.engine import ServeConfig as RServe
    from repro.serving.engine import ServingEngine as REngine
    rcfg = RCN.get_smoke_config(arch)
    rmodel, rparams = reference(rcfg)
    tokens = np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    reng = REngine(rcfg, RServe(batch=2, max_len=12), params=rparams)
    rlogits, rcache = reng.prefill(jnp.asarray(tokens))
    cfg = CN.get_smoke_config(arch)
    params = port_tree(rparams)
    prefill = make_prefill_step(cfg, 2, 12, device="cpu")
    logits, cache = prefill(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=ATOL)
    # one decode step into a cache of 13, as the reference's decode cells
    nxt = np.asarray(jnp.argmax(rlogits[:, -1], -1))[:, None].astype(
        np.int32)
    reng13 = REngine(rcfg, RServe(batch=2, max_len=13), params=rparams)
    _, rc13 = reng13.prefill(jnp.asarray(tokens))
    rdec, _ = reng13.decode(jnp.asarray(nxt), rc13, jnp.int32(12))
    _, c13 = make_prefill_step(cfg, 2, 13, device="cpu")(
        params, torch.from_numpy(tokens))
    serve = make_serve_step(cfg, 2, 13, device="cpu")
    dec, _ = serve(params, torch.from_numpy(nxt), c13, 12)
    np.testing.assert_allclose(dec.numpy(), np.asarray(rdec), atol=ATOL)
    with pytest.raises(ValueError):
        prefill(params, torch.from_numpy(tokens[:1]))
    with pytest.raises(ValueError):
        serve(params, torch.from_numpy(nxt), c13, 13)
