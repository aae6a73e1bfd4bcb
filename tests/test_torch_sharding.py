"""The logical-axes tree and the sharding rules of the port
(``repro_torch.parallel.sharding``, ``configs.param_specs``,
``train.trainer.state_shardings``) against the reference's, in one
process with no ranks.

The reference's rule functions read only a mesh's axis names and sizes, so
a ``jax.sharding.AbstractMesh`` of the production shapes (16 x 16 and 2 x 16
x 16, 256 and 512 chips) stands in for the chips, and the port plans on a
shape-only ``MeshShape`` of the same shape. Specs compare as the
reference's ``PartitionSpec`` entries, exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as RCN
from repro.parallel import sharding as RSh
from repro_torch import configs as CN
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.common import tree_items
from repro_torch.models.transformer import get_model
from repro_torch.parallel import sharding as Sh
from repro_torch.train import trainer

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "multipod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SMOKE_B, SMOKE_S = 32, 256     # divisible by both meshes' DP and 'model'


def shapes_of(tree):
    """A port tree of tensors as the reference's ShapeDtypeStructs (dicts
    and tuples kept)."""
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shapes_of(v) for v in tree)
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def leaves(tree, prefix=()):
    """``(path, leaf)`` of nested dicts and tuples (tuple leaves of specs
    and axes excluded)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and not all(
            isinstance(e, (str, type(None))) or (
                isinstance(e, tuple) and all(isinstance(x, str) for x in e))
            for e in tree):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def ref_specs(tree):
    return {p: tuple(s.spec) for p, s in leaves(tree)}


def port_specs(tree):
    return {p: s.spec for p, s in leaves(tree)}


_SPECS = {}


def specs(arch):
    """Both packages' ``param_specs`` of the full-width ``arch``."""
    if arch not in _SPECS:
        _SPECS[arch] = (RCN.param_specs(RCN.get_config(arch)),
                        CN.param_specs(CN.get_config(arch)))
    return _SPECS[arch]


@pytest.mark.parametrize("arch", CN.ARCHS)
def test_axes_tree_equals_reference(arch):
    (rshapes, raxes), (shapes, axes) = specs(arch)
    assert axes == raxes
    got = {p: tuple(t.shape) for p, t in tree_items(shapes)}
    assert got == {p: s.shape for p, s in leaves(rshapes)}
    assert all(t.device.type == "meta" for _, t in tree_items(shapes))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", CN.ARCHS)
def test_param_specs_equal_reference_on_production_meshes(arch, mesh_name,
                                                          fsdp):
    """Every leaf's spec on 256 / 512 chips, through ``state_shardings``
    on a shape-only mesh; the moments follow the params, ``step`` is
    replicated."""
    sizes, names = MESHES[mesh_name]
    (rshapes, raxes), _ = specs(arch)
    rmesh = AbstractMesh(sizes, names)
    rules = RSh.make_rules(fsdp=fsdp, data_axes=RSh.dp_axes(rmesh))
    want = ref_specs(RSh.param_shardings(raxes, rshapes, rmesh, rules))
    sh = trainer.state_shardings(CN.get_config(arch),
                                 Sh.MeshShape(names, sizes), fsdp=fsdp)
    assert port_specs(sh["params"]) == want
    assert port_specs(sh["opt_state"]["m"]) == want
    assert sh["opt_state"]["step"].spec == ()
    if fsdp:     # FSDP shards some leaf over every DP axis
        dp = names[:-1]
        assert any((dp if len(dp) > 1 else dp[0]) in s
                   for s in want.values())


def smoke_cache(arch):
    cfg = CN.get_smoke_config(arch)
    kw = {"n_ctx": cfg.n_ctx} if cfg.family in ("vlm", "audio") else {}
    return cfg, get_model(cfg).init_cache(SMOKE_B, SMOKE_S, device="meta",
                                          **kw)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", CN.ARCHS)
def test_batch_and_cache_shardings_equal_reference(arch, mesh_name):
    """On the port's ``init_cache`` meta tree of the smoke config (and its
    train batch), both packages' rule functions give the same specs."""
    sizes, names = MESHES[mesh_name]
    rmesh, mesh = AbstractMesh(sizes, names), Sh.MeshShape(names, sizes)
    cfg, cache = smoke_cache(arch)
    heads = (cfg.n_heads, cfg.n_kv_heads)
    want = ref_specs(RSh.cache_shardings(
        shapes_of(cache), rmesh, batch=SMOKE_B, seq=SMOKE_S,
        head_candidates=heads))
    got = port_specs(Sh.cache_shardings(cache, mesh, batch=SMOKE_B,
                                        seq=SMOKE_S, head_candidates=heads))
    assert got == want
    batch = CN.input_specs(cfg, CN.ShapeSpec("t", "train", SMOKE_S,
                                             SMOKE_B))["batch"]
    batch["odd"] = torch.empty((SMOKE_B + 1, 4), device="meta")
    assert port_specs(Sh.batch_shardings(batch, mesh)) == ref_specs(
        RSh.batch_shardings(shapes_of(batch), rmesh))


@pytest.mark.parametrize("arch", CN.ARCHS)
def test_real_init_axes_equal_meta_init_axes(arch):
    """A family's init at smoke size on the CPU returns the axes that its
    meta init does, and every axes leaf names one axis per dimension."""
    model = get_model(CN.get_smoke_config(arch))
    params, axes = model.init(0, "cpu", with_axes=True)
    _, meta_axes = model.init(0, "meta", with_axes=True)
    assert axes == meta_axes
    flat = dict(tree_items(axes))
    assert {p: t.dim() for p, t in tree_items(params)} == \
        {p: len(a) for p, a in flat.items()}
    assert all(Sh.is_axes_leaf(a) for a in flat.values())


def test_spec_rules_drop_what_does_not_divide():
    mesh = Sh.MeshShape(("data", "model"), (4, 16))
    rules = Sh.make_rules(fsdp=True)
    # vocab 100 does not divide by 16: replicated; embed takes 'data'
    assert Sh.spec_for_axes(("vocab", "embed"), (100, 64), mesh, rules) == \
        (None, "data")
    # a second 'model' axis on one leaf is dropped
    assert Sh.spec_for_axes(("heads", "mlp"), (32, 64), mesh, rules) == \
        ("model", None)
    assert Sh.spec_for_axes(("layers", None), (3, 5), mesh, rules) == \
        (None, None)


def test_placements_and_blocks():
    """A ('pod', 'data') entry is Shard on both mesh dims, and the blocks
    go row-major over the entry's axes."""
    mesh = Sh.MeshShape(("pod", "data", "model"), (2, 2, 2))
    s = Sh.NamedSharding(mesh, (("pod", "data"), "model"))
    assert [str(p) for p in s.placements] == [
        "S(0)", "S(0)", "S(1)"]
    assert s.block((8, 6), (1, 0, 1)) == (slice(4, 6), slice(3, 6))
    assert s.block((8, 6), (0, 1, 0)) == (slice(2, 4), slice(0, 3))
    assert [str(p) for p in Sh.replicated(mesh).placements] == ["R"] * 3
    with pytest.raises(ValueError, match="mesh order"):
        Sh.placements_for(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="two dims"):
        Sh.placements_for(mesh, ("model", "model"))


def test_mesh_shape_reads_every_mesh_kind():
    rmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    ms = Sh.mesh_shape(rmesh)
    assert ms == Sh.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert Sh.dp_axes(ms) == ("pod", "data")
    assert Sh.dp_axes(Sh.MeshShape(("data", "model"), (16, 16))) == \
        RSh.dp_axes(AbstractMesh((16, 16), ("data", "model")))
    with pytest.raises(ValueError):
        Sh.MeshShape(("data",), (2, 2))


def test_production_mesh_shapes_need_no_group():
    single = launch_mesh.make_production_mesh(shape_only=True)
    multi = launch_mesh.make_production_mesh(multi_pod=True, shape_only=True)
    assert single == Sh.MeshShape(("data", "model"), (16, 16))
    assert multi == Sh.MeshShape(("pod", "data", "model"), (2, 16, 16))
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_debug_mesh(device="cpu")


def test_constraints_pass_through_without_a_mesh():
    x = torch.randn(4, 1, 2, 8)
    assert Sh.constrain_decode_q(x) is x
    assert Sh.maybe_seq_shard_q(x) is x
    assert Sh.constrain_kv_cache(x) is x and Sh.constrain_kv_cache(None) is None
    with Sh.activation_mesh(Sh.MeshShape(("data", "model"), (2, 2))):
        # a plain tensor is one rank's whole value: left as it is
        assert Sh.constrain_decode_q(x) is x
    assert Sh._ACT_MESH.get() is None
