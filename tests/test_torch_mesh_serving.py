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
import functools
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
    # TP on 'model' (16 ranks): the smoke llama's MLP (d_ff 128) and
    # vocabulary (128) split, its 4 / 2 heads do not, so the attention's
    # projections run whole on each rank's rows, and its query sequence
    # splits over 'model' instead (the reference's maybe_seq_shard_q): the
    # MLP's, the head's and the attention core's FLOPs fall by 16 more:
    # mesh = (one - X) / dp + X / (dp * 16), X their one-card FLOPs (per
    # layer 6 T D F forward; to train, 3x that and the remat's gate and up
    # again, and the head 3 x 2 T D V; the prefill's head reads the last
    # position only; the core's two products 4 T S H hd forward, and to
    # train the remat's recompute and 2x that backward)
    cfg = CN.get_config("llama3.2-1b", **over)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hd = cfg.n_heads * cfg.hd
    x = {}
    for sh in ("train_4k", "prefill_32k"):
        B, S = CN.SHAPES[sh].global_batch, CN.SHAPES[sh].seq_len
        T = B * S
        x[sh] = (L * (18 * T * D * F + 4 * T * D * F) + 6 * T * D * V
                 + L * 16 * T * S * Hd
                 if sh == "train_4k" else
                 L * 6 * T * D * F + 2 * B * D * V + L * 4 * T * S * Hd)
        assert 16 * dp * got[sh]["flops_per_device"] == \
            16 * one[sh]["flops_per_device"] - 15 * x[sh], sh
    # the train step keeps each 'model'-split leaf in its block (no FSDP,
    # so nothing is gathered on 'data'): its all-gathers are the sequence
    # split's, one per layer of its rows' attention output [rows, S, H,
    # hd] in bf16, in the forward and again in the remat's recompute, per
    # microbatch
    from repro_torch.models.transformer import get_model, model_parallel_leaf
    from repro_torch.train import trainer
    mesh = Sh.MeshShape(*reversed(MESHES["pod16x16" if dp == 16
                                         else "multipod2x16x16"]))
    shapes, _ = CN.param_specs(cfg)
    sh = dict(tree_items(trainer.state_shardings(cfg, mesh)["params"]))
    keep = functools.partial(model_parallel_leaf, get_model(cfg))
    split = [(p, t) for p, t in tree_items(shapes)
             if Sh.model_dim(sh[p].spec) is not None]
    assert split and all(keep(p, 16) for p, _ in split)
    train = CN.SHAPES["train_4k"]
    mb = got["train_4k"]["microbatches"]
    rows = train.global_batch // dp // mb
    assert got["train_4k"]["collectives"]["all-gather"]["bytes"] == \
        mb * L * 2 * rows * train.seq_len * Hd * 2
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


def test_model_group_on_a_mesh_shape_counts_its_collectives():
    """A planner's 'model' group (a ``MeshShape``: no process group) moves
    nothing and counts each collective: a column- then row-parallel SwiGLU,
    the vocab-parallel head and loss on meta tensors at rank 3 of a 16-wide
    'model' axis run the all-reduces of the design (the MLP's sum, the
    loss's row max, sum of exponentials and gold logit), and a gather
    counts the whole result."""
    from repro_torch.models import common
    mesh = Sh.MeshShape(("data", "model"), (16, 16))
    assert Sh.model_group_of(Sh.MeshShape(("data", "model"), (4, 1)),
                             (0, 0)) is None
    mg = Sh.model_group_of(mesh, (2, 3))
    assert (mg.index, mg.size, mg.group) == (3, 16, None)
    meta = lambda *s: torch.empty(s, device="meta")
    B, S, D, F, V = 2, 8, 64, 128, 256
    x = meta(B, S, D)
    labels = torch.zeros((B, S), dtype=torch.long, device="meta")
    with Sh.model_parallel(mg):
        y = common.swiglu(x, meta(D, F // 16), meta(D, F // 16),
                          meta(F // 16, D), d_ff=F)
        logits = common.lm_head_logits(y, meta(D, V // 16), V - 8,
                                       width=V)
        loss = common.cross_entropy_loss(logits, labels, width=V)
        full = mg.all_gather(logits, -1)
    assert loss.shape == () and full.shape == (B, S, V)
    row = B * S * 4
    assert mg.calls == [("all-reduce", B * S * D * 4), ("all-reduce", row),
                        ("all-reduce", row), ("all-reduce", row),
                        ("all-gather", B * S * V * 4)]


def test_layers_follow_their_leaves():
    """A layer runs split exactly where its leaf holds this rank's 'model'
    block: ``layer_group`` gives the installed group for a block, ``None``
    for the whole dim (installed group or not) and raises for a dim that
    is neither; a SwiGLU handed whole weights under an installed group
    runs whole, with no collective, and one handed blocks sums them."""
    from repro_torch.models import common
    mg = Sh.model_group_of(Sh.MeshShape(("data", "model"), (1, 4)), (0, 1))
    meta = lambda *s: torch.empty(s, device="meta")
    assert Sh.layer_group(128, 128) is None
    with pytest.raises(ValueError, match="neither"):
        Sh.layer_group(32, 128)             # a block with no group
    x = meta(2, 8, 64)
    with Sh.model_parallel(mg):
        assert Sh.layer_group(32, 128) is mg
        assert Sh.layer_group(128, 128) is None
        for local, n in ((64, 128), (3, 10)):
            with pytest.raises(ValueError, match="neither"):
                Sh.layer_group(local, n)
        common.swiglu(x, meta(64, 128), meta(64, 128), meta(128, 64),
                      d_ff=128)
        assert mg.calls == []
        common.swiglu(x, meta(64, 32), meta(64, 32), meta(32, 64), d_ff=128)
        assert mg.calls == [("all-reduce", 2 * 8 * 64 * 4)]


# per arch: leaves kept in their 'model' block, leaves whole (on a 'model'
# axis of 4 ranks), from the smoke configs' trees
_RULE_CASES = {
    # 2 KV heads on 4 ranks: the rules keep wk whole
    "llama3.2-1b": (["embed", "stage0/attn/wq", "stage0/ffn/w_up",
                     "stage0/ffn/w_down"],
                    ["ln_f", "stage0/ln1", "stage0/attn/wk"]),
    "deepseek-v3-671b": (["stage1/ffn/w_gate", "stage1/ffn/ws_up",
                          "stage0/ffn/w_up", "stage0/attn/wq_b",
                          "stage0/attn/wkv_b", "stage0/attn/wo"],
                         ["stage0/attn/wq_a", "stage0/attn/wkv_a",
                          "stage0/attn/q_norm", "stage1/ffn/router"]),
    "llama4-maverick-400b-a17b": (["stage0/moe/ffn/w_up",
                                   "stage0/moe/attn/wq",
                                   "stage0/dense/ffn/w_gate"], []),
    "llama-3.2-vision-90b": (["stage0/selfs/attn/wq",
                              "stage0/cross/ffn/w_up",
                              "stage0/cross/attn/wq",
                              "stage0/cross/attn/wo"],
                             ["stage0/cross/ln1"]),
    "seamless-m4t-large-v2": (["decoder/self/wq", "decoder/ffn/w_up",
                               "decoder/cross/wq", "encoder/attn/wq",
                               "encoder/ffn/w_up"],
                              ["encoder/ln1", "ln_enc"]),
    "zamba2-1.2b": (["shared_attn/attn/wq", "shared_attn/ffn/w_up",
                     "supers/mamba/w_in", "supers/mamba/conv_w",
                     "tail/a_log", "tail/norm", "tail/w_out"],
                    ["ln_f"]),
    "xlstm-125m": (["embed", "lm_head", "supers/mlstm/wq",
                    "supers/mlstm/wo", "supers/slstm/wz",
                    "supers/slstm/rz"],
                   ["supers/mlstm/wo_gate", "supers/mlstm/norm",
                    "supers/slstm/norm", "supers/slstm/w_out"]),
}


@pytest.mark.parametrize("arch", sorted(_RULE_CASES))
def test_model_parallel_leaf_is_one_rule_defaulting_to_whole(arch):
    """``model_parallel_leaf``, the one rule: a leaf stays in its 'model'
    block exactly where the reference's rules split it over 'model' (the
    vocabulary, GQA, MLA and cross-attention heads, the encoder, the MLPs
    and shared experts, the Mamba mixer, the xLSTM cells, the routed
    experts where the axis divides their count, else their mlp width where
    it divides that); a leaf the rules keep whole and a path that names no
    leaf are whole."""
    from repro_torch.models.transformer import get_model, model_parallel_leaf
    cfg = CN.get_smoke_config(arch)
    model = get_model(cfg)
    paths = {"/".join(p) for p, _ in tree_items(model.init(0,
                                                           device="meta"))}
    kept, whole = _RULE_CASES[arch]
    assert set(kept + whole) <= paths
    rule = lambda p, n=4: model_parallel_leaf(model, tuple(p.split("/")), n)
    assert all(rule(p) for p in kept) and not any(rule(p) for p in whole)
    assert not rule("stage0/unnamed/wq") and not rule("stage0/attn/w_new")
    if cfg.n_experts:
        experts = [p for p in kept if p.endswith(("ffn/w_gate", "ffn/w_up"))
                   and ("moe" in p or "stage1" in p)]
        # 8 and 4 experts on 3 ranks: neither they nor their width are
        # divided, so the experts are whole; on 16 the rules split their
        # mlp dim instead, and each rank keeps its block of every expert
        assert experts and not any(rule(p, 3) for p in experts)
        assert all(rule(p, 16) for p in experts)
