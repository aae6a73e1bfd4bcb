"""Serving and the dry-run on meshes, in one process with no ranks: the
step factories' and the engine's cache shardings against the reference's
on the production meshes, the sequence-parallel combine of a decode
attention computed in blocks, the MoE routing's token group, and the
dry-run's ``single`` and ``multi`` records (counted in a spawned worker
that joins a fake world of 256 or 512 ranks).

The reference's functions take a ``jax.sharding.AbstractMesh`` of the
production shapes; the port plans on a shape-only ``MeshShape``. Specs
compare as the reference's ``PartitionSpec`` entries, exactly. The
combine runs in f32 and is held to 1e-6 of the unsplit decode (it sums the
blocks in another order: observed about 1e-7).
"""
import math
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as RCN
from repro.serving import engine as REng
from repro_torch import configs as CN
from repro_torch.launch import dryrun
from repro_torch.models import attention as A
from repro_torch.models import moe
from repro_torch.models.common import tree_items
from repro_torch.parallel import sharding as Sh
from repro_torch.serving import engine as Eng
from test_torch_sharding import (MESHES, SMOKE_B, SMOKE_S,
                                 port_specs, ref_specs)

COMBINE_ATOL = 1e-6


def both(mesh_name):
    sizes, names = MESHES[mesh_name]
    return AbstractMesh(sizes, names), Sh.MeshShape(names, sizes)


# ------------------------------------------------------------ shardings

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", CN.ARCHS)
def test_step_factories_shardings_equal_reference(arch, mesh_name):
    """``make_serve_step`` and ``make_prefill_step`` given a ``MeshShape``
    return the reference's cache and token specs (head candidates: KV
    heads and heads)."""
    rmesh, mesh = both(mesh_name)
    rcfg, cfg = RCN.get_smoke_config(arch), CN.get_smoke_config(arch)
    _, rcache, rtok = REng.make_serve_step(rcfg, rmesh, SMOKE_B, SMOKE_S)
    _, cache, tok = Eng.make_serve_step(cfg, SMOKE_B, SMOKE_S, device="cpu",
                                        mesh=mesh)
    assert port_specs(cache) == ref_specs(rcache)
    assert tok.spec == tuple(rtok.spec)
    _, rpre = REng.make_prefill_step(rcfg, rmesh, SMOKE_B, SMOKE_S)
    _, pre = Eng.make_prefill_step(cfg, SMOKE_B, SMOKE_S, device="cpu",
                                   mesh=mesh)
    assert port_specs(pre) == ref_specs(rpre)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", CN.ARCHS)
def test_engine_cache_shardings_equal_reference(arch, mesh_name):
    """The engine's head candidates (KV heads, heads and the SSM heads)
    give the reference engine's cache specs."""
    rmesh, mesh = both(mesh_name)
    rcfg, cfg = RCN.get_smoke_config(arch), CN.get_smoke_config(arch)
    want = REng.ServingEngine(rcfg, REng.ServeConfig(SMOKE_B, SMOKE_S),
                              mesh=rmesh).cache_shardings
    got = Eng.ServingEngine(cfg, Eng.ServeConfig(SMOKE_B, SMOKE_S),
                            device="cpu", mesh=mesh).cache_shardings
    assert port_specs(got) == ref_specs(want)
    assert Eng.engine_head_candidates(cfg)[:2] == \
        Eng.step_head_candidates(cfg)


def test_hybrid_engine_shards_ssm_heads_where_the_steps_do_not():
    """The engine's third head candidate shards zamba2's SSM state on its
    heads (the reference engine's ``ssm_expand * d_model //
    ssm_head_dim``); the step factories' candidates leave it whole."""
    cfg = CN.get_config("zamba2-1.2b")
    mesh = Sh.MeshShape(("data", "model"), (16, 16))
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    eng = Eng.ServingEngine(cfg, Eng.ServeConfig(32, 4096), device="cpu",
                            mesh=mesh).cache_shardings
    _, step, _ = Eng.make_serve_step(cfg, 32, 4096, device="cpu", mesh=mesh)
    ssm = eng["states"]["supers"]["mamba"]["ssm"].spec
    assert ssm[3] == "model" and heads % 16 == 0
    assert step["states"]["supers"]["mamba"]["ssm"].spec[3] is None


def test_mesh_shape_plans_but_runs_no_step():
    cfg = CN.get_smoke_config("llama3.2-1b")
    mesh = Sh.MeshShape(("data", "model"), (2, 2))
    step, _, _ = Eng.make_serve_step(cfg, 4, 16, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="DeviceMesh"):
        step({}, torch.zeros((4, 1), dtype=torch.int32), {}, 3)
    assert not isinstance(Eng.make_serve_step(cfg, 4, 16, device="cpu"),
                          tuple)


# ------------------------------------------------------------ the combine

def decode_case(B=3, S=64, H=8, Hkv=2, D=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=gen)
    k = torch.randn((B, S, Hkv, D), generator=gen)
    v = torch.randn((B, S, Hkv, D), generator=gen)
    return q, k, v


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 16])
def test_split_decode_equals_unsplit(n_blocks):
    """Blocks of 64 entries, rows valid to 64, 33 and 1: with 16 blocks
    the last row's blocks 1-15 and the middle row's 9-15 hold no valid
    entry."""
    q, k, v = decode_case()
    valid = torch.tensor([64, 33, 1], dtype=torch.int32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = A._decode_core_grouped(q, k, v, valid, scale, 4)
    got = A.split_decode(q, k, v, valid, n_blocks)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= COMBINE_ATOL


def test_block_with_no_valid_entry_adds_nothing():
    q, k, v = decode_case(B=1, S=8)
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = torch.tensor([4])
    full = A.decode_partial(q, k[:, :4], v[:, :4], valid, scale, 4)
    empty = A.decode_partial(q, k[:, 4:], v[:, 4:], torch.tensor([0]),
                             scale, 4)
    assert bool((empty[0] == Sh.NEG).all()) and bool((empty[1] == 0).all())
    assert bool((empty[2] == 0).all())
    assert torch.equal(Sh.combine_blocks([full, empty]),
                       Sh.combine_blocks([full]))


def test_cache_block_writes_only_its_positions():
    blk = Sh.CacheBlock(4, 8)
    dst = torch.zeros((2, 4, 3))
    src = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    blk.write(dst, src, 2)            # positions 2..7: 4..7 are this block's
    assert torch.equal(dst, src[:, 2:6])
    dst.zero_()
    blk.write(dst, src[:, :1], 9)     # beyond the block: nothing
    assert not dst.any()
    assert blk.local_valid(torch.tensor([1, 6, 30])).tolist() == [0, 2, 4]


def test_token_group_routes_as_the_whole_batch():
    """Two halves of a batch routed under a :class:`TokenGroup` each (the
    earlier half's per-expert counts standing in for the all-gather) keep
    exactly the copies that routing the whole batch keeps."""
    gen = torch.Generator().manual_seed(0)
    E, k, T, D = 8, 2, 24, 16
    p = {"router": torch.randn((D, E), generator=gen)}
    x = torch.randn((T, D), generator=gen)
    kw = dict(top_k=k, n_experts=E, capacity_factor=1.0)
    whole = moe.route(p, x, **kw)
    keep = torch.zeros(T * k, dtype=torch.bool)
    keep[whole["order"]] = whole["keep"]

    class Halves(Sh.TokenGroup):
        def before(self, count):
            return counts[0] if self.index else torch.zeros_like(count)

    counts, got = [], []
    for i, half in enumerate((x[:T // 2], x[T // 2:])):
        with Sh.token_group(Halves(i, 2, None, None)):
            r = moe.route(p, half, **kw)
        assert r["cap"] == whole["cap"] and r["rows"] == min(r["cap"],
                                                             T // 2)
        counts.append(torch.bincount(r["idx"].reshape(-1), minlength=E))
        m = torch.zeros(T // 2 * k, dtype=torch.bool)
        m[r["order"]] = r["keep"]
        got.append(m)
    assert (~keep).any()              # the capacity drops copies here
    assert torch.equal(torch.cat(got), keep)


# ------------------------------------------------------------ the dry-run

SMOKE_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "head_dim")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The smoke llama's four cells on each mesh (``single`` and
    ``multi`` in spawned workers of the fake world, both counted while
    this process counts ``h100x1``)."""
    root = tmp_path_factory.mktemp("mesh_cells")
    smoke = CN.get_smoke_config("llama3.2-1b")
    over = {f: getattr(smoke, f) for f in SMOKE_FIELDS}

    def write(mesh_name):
        return dryrun.write_cells(["llama3.2-1b"], list(CN.SHAPES),
                                  root=root, overrides=over,
                                  mesh_name=mesh_name, log=lambda *a: None)

    with ThreadPoolExecutor(2) as pool:
        meshes = {m: pool.submit(write, m) for m in ("single", "multi")}
        out = {"h100x1": write("h100x1")}
        out.update({m: f.result() for m, f in meshes.items()})
    return out, over


@pytest.mark.parametrize("mesh_name,dp", [("single", 16), ("multi", 32)])
def test_mesh_records_hold_the_exact_identities(cells, mesh_name, dp):
    recs, over = cells
    one = {sh: r for (_, sh), r in recs["h100x1"].items()}
    got = {sh: r for (_, sh), r in recs[mesh_name].items()}
    assert got["long_500k"]["status"] == "skip"
    for sh in ("train_4k", "prefill_32k", "decode_32k"):
        r = got[sh]
        assert r["status"] == "ok" and r["mesh"] == mesh_name, r
        assert r["n_devices"] == dp * 16 and r["fsdp"] is False
        assert sorted(r["collectives"]) == sorted(dryrun.COLLECTIVES)
    # no TP: a train or prefill cell's FLOPs split over the DP ranks
    for sh in ("train_4k", "prefill_32k"):
        assert got[sh]["flops_per_device"] * dp == one[sh]["flops_per_device"]
    # the train step gathers each leaf its shardings split, whole, once
    cfg = CN.get_config("llama3.2-1b", **over)
    from repro_torch.train import trainer
    mesh = Sh.MeshShape(*reversed(MESHES["pod16x16" if dp == 16
                                         else "multipod2x16x16"]))
    shapes, _ = CN.param_specs(cfg)
    sh = dict(tree_items(trainer.state_shardings(cfg, mesh)["params"]))
    split = sum(t.numel() * t.element_size() for p, t in tree_items(shapes)
                if any(e is not None for e in sh[p].spec))
    assert split > 0
    assert got["train_4k"]["collectives"]["all-gather"]["bytes"] == split
    # a decode cell holds 1 / (DP x 16) of the cache, its rows' tokens and
    # its blocks of the parameters
    spec = CN.SHAPES["decode_32k"]
    cache = CN.input_specs(cfg, spec)["cache"]
    whole = sum(t.numel() * t.element_size() for t in
                torch.utils._pytree.tree_leaves(cache))
    local = sum(math.prod(s.stop - s.start for s in sh[p].block(
        tuple(t.shape), (0,) * len(mesh.sizes))) * t.element_size()
        for p, t in tree_items(shapes))
    rows = spec.global_batch // dp * 4
    assert got["decode_32k"]["memory"]["argument_size_in_bytes"] == \
        local + rows + whole // (dp * 16) + 4


def test_fsdp_on_one_card_and_mesh_cells_outside_the_world():
    with pytest.raises(ValueError, match="fsdp"):
        dryrun.lower_cell("granite-20b", "train_4k", {"fsdp": True})
    with pytest.raises(RuntimeError, match="fake world"):
        dryrun.lower_cell("llama3.2-1b", "train_4k", mesh_name="single")
    with pytest.raises(ValueError, match="unknown mesh"):
        dryrun.lower_cell("llama3.2-1b", "train_4k", mesh_name="pod")
