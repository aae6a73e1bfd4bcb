"""The ranks of ``tests/test_torch_mesh.py``: every multi-rank check of the
port's meshes, run by each of a few ``gloo`` ranks spawned on the CPU.

``main`` joins the group (``file://`` rendezvous, no network), runs each
check in turn on every rank (they are collective: every rank runs them in
the same order) and writes ``rank<r>.json`` with each check's result, or
the traceback it raised. Imports torch and the port only.
"""
import datetime
import functools
import json
import math
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

CFG_ARCH = "llama3.2-1b"
# a MoE arch whose smoke routing drops copies at B x S tokens (8 experts,
# top 2, routed in 8 chunks of 16 tokens with a capacity of 5 each)
MOE_ARCH = "deepseek-v3-671b"
B, S = 8, 16          # 8 rows: 2 per DP rank of a 2 x 2 mesh
STEPS = 2

# the serving engine on the meshes: each family at smoke size in f32, the
# reference's weights (pickled by the parent) through the bridge. 6 rows
# (3 per DP rank of 2 x 2; no smoke cache dim before the batch dim is 6,
# so the reference's rule finds the batch dim), 8-token prompts, 4 new
# tokens, caches of 16 entries (8 or 4 per 'model' rank)
SERVE_CASES = {
    "llama": ("llama3.2-1b", {}),
    "mla": ("deepseek-v3-671b", {}),
    "mla_absorbed": ("deepseek-v3-671b", {"mla_absorbed": True}),
    "hybrid": ("zamba2-1.2b", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "xlstm": ("xlstm-125m", {}),
}
SERVE_B, SERVE_S, SERVE_NEW, SERVE_L = 6, 8, 4, 16
SERVE_MESHES = ("2x2", "1x4")
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def serve_file(name: str) -> str:
    """The pickle the parent writes for the serving check: the prompts
    (``"inputs"``) or an arch's reference weights."""
    return f"serve-{name}.pkl"


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over two trees' leaves."""
    from repro_torch.models.common import tree_leaves
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float((y.double() ** 2).sum()) for y in tree_leaves(b))
    return math.sqrt(num / den)


def _full(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.full_tensor(), tree)


def _same(a, b) -> bool:
    from repro_torch.models.common import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _setup(arch=CFG_ARCH):
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.optim import adamw
    cfg = configs.get_smoke_config(arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(cfg.vocab_size, B, S)
    return cfg, opt, [synth_batch(dcfg, i, "cpu") for i in range(STEPS)]


def check_blocks(meshes, cases):
    """Each case's local block (``distribute(...).to_local()``) and
    ``NamedSharding.block`` against the reference's
    ``devices_indices_map`` at this rank's mesh coordinate."""
    from repro_torch.parallel import sharding as Sh
    out = []
    for case in cases:
        mesh = meshes[case["mesh"]]
        shape = tuple(case["shape"])
        spec = tuple(tuple(e) if isinstance(e, list) else e
                     for e in case["spec"])
        sh = Sh.NamedSharding(mesh, spec)
        full = torch.arange(math.prod(shape), dtype=torch.float32).reshape(
            shape)
        coord = tuple(mesh.get_coordinate())
        flat = 0
        for c, n in zip(coord, Sh.mesh_shape(mesh).sizes):
            flat = flat * n + c
        want = tuple(slice(a, b) for a, b in case["blocks"][flat])
        local = Sh.distribute(full, sh).to_local()
        out.append({"name": case["name"], "coord": coord,
                    "local": torch.equal(local, full[want]),
                    "block": sh.block(shape, coord) == want})
    return out


def check_sharded_step(meshes, fsdp, arch=CFG_ARCH):
    """Two steps on the 2 x 2 mesh against the one-device step on the
    same batches: losses and parameters, and the share of the state this
    rank holds."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import trainer
    cfg, opt, batches = _setup(arch)
    mesh = meshes["2x2"]
    st = trainer.init_train_state(cfg, opt, 0, "cpu")
    sh = trainer.state_shardings(cfg, mesh, fsdp=fsdp)
    placed = trainer.shard_state({"params": st.params,
                                  "opt_state": st.opt_state},
                                 {"params": sh["params"],
                                  "opt_state": sh["opt_state"]})
    held = sum(t.to_local().numel() for t in tree_leaves(placed["params"]))
    total = sum(t.numel() for t in tree_leaves(st.params))
    step = trainer.make_train_step(cfg, opt, mesh, fsdp=fsdp)
    one = trainer.make_train_step(cfg, opt)
    p, o = placed["params"], placed["opt_state"]
    q, r = st.params, st.opt_state
    losses, want = [], []
    for batch in batches:
        p, o, m = step(p, o, batch)
        q, r, n = one(q, r, batch)
        losses.append(float(m["loss"]))
        want.append(float(n["loss"]))
    return {"losses": losses, "want": want,
            "params_rel": _rel(_full(p), q),
            "moments_rel": _rel(_full(o["v"]), r["v"]),
            "steps": int(o["step"].full_tensor()), "held": held / total}


def check_compressed_step(meshes):
    """The compressed step on the (2, 2, 1) pod mesh against its
    emulation in this process: per pod the mean of its two 'data' ranks'
    gradients, compressed with the pod's error, averaged over the pods,
    then ``apply_updates``."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import get_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression as C
    from repro_torch.train import trainer
    cfg, opt, batches = _setup()
    mesh = meshes["pod"]
    comp = C.CompressionConfig(kind="int8")
    st = trainer.init_train_state(cfg, opt, 0, "cpu")
    sh = trainer.state_shardings(cfg, mesh, fsdp=True)
    placed = trainer.shard_state({"params": st.params,
                                  "opt_state": st.opt_state},
                                 {"params": sh["params"],
                                  "opt_state": sh["opt_state"]})
    step = trainer.make_compressed_train_step(cfg, opt, mesh, comp,
                                              fsdp=True)
    vg = trainer._value_and_grad(get_model(cfg))
    pod = mesh.get_coordinate()[0]
    p, o = placed["params"], placed["opt_state"]
    err = C.init_error_state(comp, st.params)
    q, r = st.params, st.opt_state
    errs = [C.init_error_state(comp, st.params) for _ in range(2)]
    out = {"loss": [], "want_loss": [], "params_err": [], "err_err": [],
           "wire": [], "want_wire": []}
    for batch in batches:
        p, o, err, m = step(p, o, err, batch)
        quarter = [vg(trainer.trainable(q),
                      {k: v[2 * i:2 * i + 2] for k, v in batch.items()})
                   for i in range(4)]
        pods, losses = [], []
        for k in range(2):
            (ga, la, _), (gb, lb, _) = quarter[2 * k], quarter[2 * k + 1]
            g = tree_map(lambda a, b: (a + b) / 2, ga, gb)
            g_hat, errs[k], wire = C.compressed_psum_pod(comp, g, errs[k])
            pods.append(g_hat)
            losses.append((la + lb) / 2)
        avg = tree_map(lambda a, b: C._div(a + b, 2), *pods)
        q, r, _ = adamw.apply_updates(opt, q, avg, r)
        out["loss"].append(float(m["loss"]))
        out["want_loss"].append(float((losses[0] + losses[1]) / 2))
        out["params_err"].append(max(float((a - b).abs().max()) for a, b in
                                     zip(tree_leaves(_full(p)),
                                         tree_leaves(q))))
        out["err_err"].append(max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(tree_leaves(err),
                                                  tree_leaves(errs[pod]))))
        out["wire"].append(m["wire_bytes_pod"])
        out["want_wire"].append(sum(t.numel() + 4
                                    for t in tree_leaves(st.params)))
    return out


def check_checkpoint(meshes, ckpt_dir):
    """A state saved from the (1, 4) mesh restored onto (2, 2) and onto no
    mesh, bit for bit, with the target shardings' placements."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.common import tree_items
    from repro_torch.train import trainer
    cfg, opt, _ = _setup()
    st = trainer.init_train_state(cfg, opt, 3, "cpu")
    full = {"params": st.params, "opt_state": st.opt_state}

    def shardings(mesh):
        sh = trainer.state_shardings(cfg, mesh, fsdp=True)
        return {"params": sh["params"], "opt_state": sh["opt_state"]}

    saved = trainer.shard_state(full, shardings(meshes["1x4"]))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(5, saved)
    onto = shardings(meshes["2x2"])
    back = mgr.restore(5, saved, onto)
    plain = mgr.restore(5, saved)
    placements = all(
        list(t.placements) == s.placements
        for (_, t), (_, s) in zip(tree_items(back), tree_items(onto)))
    return {"onto_mesh": _same(_full(back), full),
            "placements": placements,
            "onto_no_mesh": _same(plain, full),
            "steps": mgr.all_steps()}


def check_crash_restart(meshes, ckpt_dir):
    """``run_training`` on the 2 x 2 mesh with FSDP and a fault at step 3
    resumes from the step-2 checkpoint and ends bit for bit where the
    uninterrupted meshed run does."""
    from repro_torch.launch.train import run_training
    kw = dict(steps=4, batch=B, seq=S, ckpt_every=2, log_every=4,
              mesh=meshes["2x2"], fsdp=True, device="cpu")
    a = run_training(CFG_ARCH, ckpt_dir=os.path.join(ckpt_dir, "a"),
                     fault_at=(3,), **kw)
    b = run_training(CFG_ARCH, ckpt_dir=os.path.join(ckpt_dir, "b"), **kw)
    return {"restarts": [a["restarts"], b["restarts"]],
            "restored_from": a["restored_from"],
            "same": _same(_full(a["state"]["params"]),
                          _full(b["state"]["params"]))}


def check_meshes():
    from repro_torch.launch import mesh as M
    debug = M.make_debug_mesh(device="cpu")
    try:
        M.make_production_mesh(device="cpu")
        production = "built"
    except ValueError as e:
        production = str(e)
    return {"debug": [list(debug.mesh_dim_names), list(debug.shape)],
            "production": production}


def check_constraints(meshes):
    """Under an installed mesh the helpers redistribute a DTensor to the
    reference's spec and keep its values."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.parallel import sharding as Sh
    mesh = meshes["2x2"]
    x = torch.arange(4 * 8 * 2 * 3, dtype=torch.float32).reshape(4, 8, 2, 3)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    with Sh.activation_mesh(mesh):
        kv = Sh.constrain_kv_cache(d)
        q = Sh.constrain_decode_q(d[:, :1])
        sq = Sh.maybe_seq_shard_q(d[:, :, :1])     # 1 head: not divisible
    return {"kv": [str(p) for p in kv.placements],
            "q": [str(p) for p in q.placements],
            "seq_q": [str(p) for p in sq.placements],
            "values": torch.equal(kv.full_tensor(), x)
            and torch.equal(sq.full_tensor(), x[:, :, :1])}


def sequence_dims(cfg) -> dict:
    """``{path: dim}`` of the cache leaves that grow with ``max_len``
    (the self-attention K/V and latents), found by growing it by one."""
    from repro_torch.models.common import tree_items
    from repro_torch.models.transformer import get_model

    def items(L):
        cache = get_model(cfg).init_cache(SERVE_B, L, device="meta")
        return dict(_leaves(cache))

    a, b = items(SERVE_L), items(SERVE_L + 1)
    return {p: next(d for d, (x, y) in enumerate(zip(t.shape, b[p].shape))
                    if x != y)
            for p, t in a.items() if t.shape != b[p].shape}


def _leaves(tree, prefix=()):
    """``(path, tensor)`` of a cache's nested dicts and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _load(serve_dir: str, name: str, deadline: float):
    """The parent's pickle ``name``, once it has appeared."""
    path = os.path.join(serve_dir, serve_file(name))
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in time")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def check_serving(meshes, serve_dir, timeout_s):
    """Each family's ``ServingEngine`` on the 2 x 2 and 1 x 4 meshes with
    the reference's weights: the global greedy tokens, this rank's rows'
    logits (prefill, then decode teacher-forced on those tokens), its
    cache blocks' shapes against ``NamedSharding.block``, whether it holds
    a whole-sequence leaf, and the all-gathers of one decode step
    (``CommDebugMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import configs
    from repro_torch.models import weights
    from repro_torch.models.transformer import get_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    deadline = time.monotonic() + timeout_s
    inputs = _load(serve_dir, "inputs", deadline)
    prompts = torch.from_numpy(inputs["prompts"])
    out = {}
    for name, (arch, over) in SERVE_CASES.items():
        cfg = configs.get_smoke_config(arch, **over, **F32)
        params = weights.from_reference(_load(serve_dir, arch, deadline),
                                        "cpu")
        ctx = (torch.from_numpy(inputs["ctx"]) if cfg.family == "vlm"
               else None)
        sdims = sequence_dims(cfg)
        full = dict(_leaves(get_model(cfg).init_cache(SERVE_B, SERVE_L,
                                                      device="meta")))
        for mesh_name in SERVE_MESHES:
            mesh = meshes[mesh_name]
            coord = tuple(mesh.get_coordinate())
            tp = mesh.shape[mesh.mesh_dim_names.index("model")]
            eng = ServingEngine(cfg, ServeConfig(SERVE_B, SERVE_L),
                                params=params, device="cpu", mesh=mesh)
            tokens = eng.generate(prompts, SERVE_NEW, ctx=ctx)
            logits, cache = eng.prefill(prompts, ctx)
            sh = dict(_leaves(eng.cache_shardings))
            blocks_ok, whole = True, False
            for p, t in _leaves(cache):
                want = tuple(s.stop - s.start for s in sh[p].block(
                    tuple(full[p].shape), coord))
                blocks_ok &= tuple(t.shape) == want
                whole |= p in sdims and tp > 1 \
                    and t.shape[sdims[p]] == SERVE_L
            steps = [logits]
            for i in range(SERVE_NEW - 1):
                tok = torch.from_numpy(tokens[:, i:i + 1])
                comm = CommDebugMode()
                with comm:
                    logits, cache = eng.decode(tok, cache, SERVE_S + i)
                steps.append(logits)
            gathers = sum(n for op, n in comm.get_comm_counts().items()
                          if "gather" in str(op))
            out[f"{name}-{mesh_name}"] = {
                "tokens": tokens.tolist(),
                "rows": eng.rows(torch.arange(SERVE_B)).tolist(),
                "logits": [t[:, -1].double().tolist() for t in steps],
                "blocks": blocks_ok, "whole_sequence_leaf": whole,
                "decode_gathers": gathers}
    return out



# ------------------------------------------------------------ TP and EP

LAYER_B, LAYER_S, LAYER_L = 3, 8, 16     # rows, prompt, cache entries
LAYER_VOCAB = 120                        # pads to 256: masked columns


def _draw(gen, *shape):
    return torch.randn(shape, generator=gen) / math.sqrt(shape[0])


def _rel_max(pairs) -> float:
    """The largest ||got - want|| / ||want|| over ``(got, want)`` pairs."""
    return max(float((g.double() - w.double()).norm() / w.double().norm())
               for g, w in pairs)


def _grads(out, leaves):
    """The gradients of ``sum(out * fixed weights)`` with respect to
    ``leaves`` (the weights drawn from a seed: the same on every rank)."""
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    return torch.autograd.grad((out * w).sum(), leaves)


def _leafs(tree):
    return {k: v.detach().clone().requires_grad_() for k, v in tree.items()}


def twin_gqa(mg, gen):
    """``apply_gqa`` with the heads split (and the smoke llama's 2 KV heads
    split on 2 ranks, whole on 4) against the whole layer: the prefill's
    output and gradients (x and this rank's blocks of the weights), then
    one decode step over a sequence-split cache block."""
    from repro_torch.models import attention as A
    from repro_torch.parallel import sharding as Sh
    D, H, Hkv, hd = 64, 4, 2, 16
    p = _leafs({"wq": _draw(gen, D, H, hd), "wk": _draw(gen, D, Hkv, hd),
                "wv": _draw(gen, D, Hkv, hd), "wo": _draw(gen, H, hd, D)})
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)
    xs = x[:, :LAYER_S].clone().requires_grad_()
    kv = mg.block(Hkv) if mg.splits(Hkv) else slice(None)
    loc = _leafs({"wq": p["wq"][:, mg.block(H)], "wk": p["wk"][:, kv],
                  "wv": p["wv"][:, kv], "wo": p["wo"][mg.block(H)]})
    pos = torch.arange(LAYER_S)
    want, _ = A.apply_gqa(p, xs, positions=pos)
    gw = _grads(want, [xs, p["wq"], p["wk"], p["wv"], p["wo"]])
    xl = xs.detach().clone().requires_grad_()
    with Sh.model_parallel(mg):
        got, _ = A.apply_gqa(loc, xl, positions=pos, n_heads=H,
                             n_kv_heads=Hkv)
        gg = _grads(got, [xl, loc["wq"], loc["wk"], loc["wv"], loc["wo"]])
    grads = _rel_max([(gg[0], gw[0]), (gg[1], gw[1][:, mg.block(H)]),
                      (gg[2], gw[2][:, kv]), (gg[3], gw[3][:, kv]),
                      (gg[4], gw[4][mg.block(H)])])
    # decode: the prompt, then one token at position LAYER_S
    cache = [torch.zeros((LAYER_B, LAYER_L, Hkv, hd)) for _ in range(2)]
    n = LAYER_L // mg.size
    blk = Sh.CacheBlock(mg.index * n, (mg.index + 1) * n, mg.group)
    block = [torch.zeros((LAYER_B, n, Hkv, hd)) for _ in range(2)]
    with torch.no_grad():
        A.apply_gqa(p, x[:, :LAYER_S], positions=pos, cache=cache)
        step = torch.tensor([LAYER_S])
        want_d, _ = A.apply_gqa(p, x[:, LAYER_S:], positions=step,
                                cache=cache, cache_pos=LAYER_S)
        with Sh.model_parallel(mg), Sh.cache_block(blk):
            A.apply_gqa(loc, x[:, :LAYER_S], positions=pos, cache=block,
                        n_heads=H, n_kv_heads=Hkv)
            got_d, _ = A.apply_gqa(loc, x[:, LAYER_S:], positions=step,
                                   cache=block, cache_pos=LAYER_S,
                                   n_heads=H, n_kv_heads=Hkv)
    # the cache blocks (some hold no written entry): against the largest
    # entry of the whole cache
    cached = max(float((b - c[:, blk.start:blk.stop]).abs().max())
                 / float(c.abs().max()) for b, c in zip(block, cache))
    return {"prefill": _rel_max([(got, want)]), "prefill_grads": grads,
            "decode": _rel_max([(got_d, want_d)]), "cache": cached,
            "kv_split": mg.splits(Hkv)}


def twin_mlps(mg, gen):
    """SwiGLU and the gelu MLP column- then row-parallel on the mlp dim
    against the whole MLP: outputs and gradients."""
    from repro_torch.models import common
    from repro_torch.parallel import sharding as Sh
    D, Fd = 64, 128
    b = mg.block(Fd)
    x = torch.randn((LAYER_B, LAYER_S, D), generator=gen)
    out = {}
    for name, fn, p, cut in (
            ("swiglu", common.swiglu,
             {"w_gate": _draw(gen, D, Fd), "w_up": _draw(gen, D, Fd),
              "w_down": _draw(gen, Fd, D)},
             {"w_gate": (slice(None), b), "w_up": (slice(None), b),
              "w_down": (b,)}),
            ("gelu", common.gelu_mlp,
             {"w_up": _draw(gen, D, Fd), "b_up": torch.randn(
                 (Fd,), generator=gen), "w_down": _draw(gen, Fd, D),
              "b_down": torch.randn((D,), generator=gen)},
             {"w_up": (slice(None), b), "b_up": (b,), "w_down": (b,),
              "b_down": (slice(None),)})):
        p = _leafs(p)
        loc = _leafs({k: v[cut[k]] for k, v in p.items()})
        xw, xl = (x.clone().requires_grad_() for _ in range(2))
        want = fn(xw, *p.values())
        gw = _grads(want, [xw, *p.values()])
        with Sh.model_parallel(mg):
            got = fn(xl, *loc.values(), d_ff=Fd)
            gg = _grads(got, [xl, *loc.values()])
        out[name] = _rel_max([(got, want)])
        out[name + "_grads"] = _rel_max(
            [(gg[0], gw[0])] + [(g, w[cut[k]]) for g, w, k in
                                zip(gg[1:], gw[1:], p)])
    return out


def twin_vocab(mg, gen):
    """The vocab-parallel embedding, head (its padded columns masked by
    global index) and cross entropy against the whole ones: the loss and
    its gradients with respect to the hidden states, the embedding and
    the head."""
    from repro_torch.models import common
    from repro_torch.parallel import sharding as Sh
    D, V = 64, LAYER_VOCAB
    W = common.padded_vocab(V)
    emb = torch.randn((V, D), generator=gen).requires_grad_()
    head = _draw(gen, D, W).requires_grad_()
    tok = torch.randint(0, V, (LAYER_B, LAYER_S), generator=gen)
    lab = torch.randint(0, V, (LAYER_B, LAYER_S), generator=gen)
    x = torch.randn((LAYER_B, LAYER_S, D), generator=gen)

    def loss(e, h):
        z = common.embed_lookup(e, tok, V) + x
        logits = common.lm_head_logits(z, h, V, width=W)
        return common.cross_entropy_loss(logits, lab, width=W)

    want = loss(emb, head)
    gw = torch.autograd.grad(want, [emb, head])
    e_loc = emb[mg.block(V)].detach().clone().requires_grad_()
    h_loc = head[:, mg.block(W)].detach().clone().requires_grad_()
    with Sh.model_parallel(mg):
        got = loss(e_loc, h_loc)
        gg = torch.autograd.grad(got, [e_loc, h_loc])
    return {"loss": abs(float(got) - float(want)) / abs(float(want)),
            "grads": _rel_max([(gg[0], gw[0][mg.block(V)]),
                               (gg[1], gw[1][:, mg.block(W)])])}


def twin_moe(mg, gen):
    """The smoke deepseek MoE layer (8 experts, top 2, one shared expert)
    with its experts split over 'model' (EP) and the shared expert's mlp
    dim (TP) against the whole layer: output, aux values exactly, and
    the gradients."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as Sh
    D, E, Fd, k = 64, 8, 32, 2
    p, _ = moe.init_moe(gen, D, Fd, E, 1, Fd, torch.float32, "cpu")
    p = _leafs(p)
    eb, fb = mg.block(E), mg.block(Fd)
    cut = {"router": (slice(None),), "w_gate": (eb,), "w_up": (eb,),
           "w_down": (eb,), "ws_gate": (slice(None), fb),
           "ws_up": (slice(None), fb), "ws_down": (fb,)}
    loc = _leafs({n: p[n][cut[n]] for n in p})
    x = torch.randn((LAYER_B, LAYER_S, D), generator=gen)
    xw, xl = (x.clone().requires_grad_() for _ in range(2))
    kw = dict(top_k=k, n_experts=E, capacity_factor=1.0)
    want, aw = moe.apply_moe(p, xw, **kw)
    gw = _grads(want + aw["load_balance_loss"], [xw, *p.values()])
    with Sh.model_parallel(mg):
        got, ag = moe.apply_moe(loc, xl, shared_width=Fd, **kw)
        gg = _grads(got + ag["load_balance_loss"], [xl, *loc.values()])
    return {"out": _rel_max([(got, want)]),
            "aux": all(torch.equal(ag[n], aw[n]) for n in aw),
            "dropped": float(aw["dropped_fraction"]),
            "grads": _rel_max([(gg[0], gw[0])] + [
                (g, w[cut[n]]) for g, w, n in zip(gg[1:], gw[1:], p)])}


def check_layers(meshes):
    """Every layer twin on the 2 x 2 and 1 x 4 meshes' 'model' groups."""
    from repro_torch.parallel import sharding as Sh
    out = {}
    for mesh_name in SERVE_MESHES:
        mg = Sh.model_group_of(meshes[mesh_name])
        gen = torch.Generator().manual_seed(7)
        out[mesh_name] = {"gqa": twin_gqa(mg, gen),
                          "mlp": twin_mlps(mg, gen),
                          "vocab": twin_vocab(mg, gen),
                          "moe": twin_moe(mg, gen)}
    return out


def _shapes(tree, shapes, shardings, keep, tp):
    """Per leaf: whether its spec splits it over 'model', whether its layer
    runs split (``keep``), and its shape on this rank beside the whole."""
    from repro_torch.models.common import tree_items
    from repro_torch.parallel import sharding as Sh
    sh, whole = dict(tree_items(shardings)), dict(tree_items(shapes))
    out = []
    for path, t in tree_items(tree):
        d = Sh.model_dim(sh[path].spec)
        out.append({"path": "/".join(path), "split": d is not None,
                    "kept": keep(path), "shape": list(t.shape),
                    "whole": list(whole[path].shape), "dim": d, "tp": tp})
    return out


def check_compute_shapes(meshes):
    """The shapes the sharded step and the serving engine compute on, for
    the smoke llama (every layer parallel) and deepseek (MLA whole, EP),
    on both meshes."""
    from repro_torch import configs
    from repro_torch.models.transformer import (get_model,
                                                model_parallel_leaf)
    from repro_torch.parallel import sharding as Sh
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.train import trainer
    out = {}
    for arch in (CFG_ARCH, MOE_ARCH):
        cfg, opt, _ = _setup(arch)
        model = get_model(cfg)
        shapes, axes = configs.param_specs(cfg)
        st = trainer.init_train_state(cfg, opt, 0, "cpu")
        for mesh_name in SERVE_MESHES:
            mesh = meshes[mesh_name]
            tp = Sh.mesh_shape(mesh).shape["model"]
            keep = lambda path: model_parallel_leaf(model, path, tp)
            sh = trainer.state_shardings(cfg, mesh)["params"]
            placed = trainer.shard_state(st.params, sh)
            step = trainer.make_train_step(cfg, opt, mesh)
            local = step.pieces["local"](placed)
            eng = ServingEngine(cfg, ServeConfig(SERVE_B, SERVE_L),
                                params=st.params, device="cpu", mesh=mesh)
            out[f"{arch}-{mesh_name}"] = {
                "step": _shapes(local, shapes, sh, keep, tp),
                "engine": _shapes(eng.params, shapes,
                                  Sh.param_shardings(axes, shapes, mesh),
                                  keep, tp)}
    return out


def check_compressed_model_blocks(meshes):
    """On the (2, 1, 2) mesh (two pods, a 'model' axis of two ranks): (a)
    ``compressed_psum_pod`` on this rank's 'model' blocks of a whole
    gradient (and error) against the whole leaves' compression, int8 and
    top-k, cut to the same blocks; (b) the compressed step (kind "none")
    against its emulation on whole gradients; (c) one int8 step's error
    leaves are 'model' blocks where the gradients are."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import (get_model,
                                                model_parallel_leaf)
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression as C
    from repro_torch.parallel import sharding as Sh
    from repro_torch.train import trainer
    cfg, opt, batches = _setup()
    mesh = meshes["podtp"]
    mg = Sh.model_group_of(mesh)
    vg = trainer._value_and_grad(get_model(cfg))
    st = trainer.init_train_state(cfg, opt, 0, "cpu")
    sh = trainer.state_shardings(cfg, mesh)
    keep = functools.partial(model_parallel_leaf, get_model(cfg))
    g, _, _ = vg(trainer.trainable(st.params), batches[0])

    def block(t, s, path=None):
        d = Sh.model_dim(s.spec)
        return t if d is None else t[(slice(None),) * d + (
            mg.block(t.shape[d]),)]

    blocks = tree_map(block, g, sh["params"])
    split = [tuple(a.shape) != tuple(b.shape)
             for a, b in zip(tree_leaves(blocks), tree_leaves(g))]
    out = {"unit": {}}
    for kind in ("int8", "topk"):
        comp = C.CompressionConfig(kind=kind)
        err = tree_map(lambda t: (t * 1e-3).to(torch.bfloat16), g)
        want, werr, wwire = C.compressed_psum_pod(comp, g, err)
        got, gerr, gwire = C.compressed_psum_pod(
            comp, blocks, tree_map(block, err, sh["params"]),
            model_group=mg, split=split)
        out["unit"][kind] = {
            "grads": _same(got, tree_map(block, want, sh["params"])),
            "err": _same(gerr, tree_map(block, werr, sh["params"])),
            "wire": gwire == wwire, "split": sum(split)}

    def run(kind, steps):
        comp = C.CompressionConfig(kind=kind)
        placed = trainer.shard_state({"params": st.params,
                                      "opt_state": st.opt_state},
                                     {"params": sh["params"],
                                      "opt_state": sh["opt_state"]})
        step = trainer.make_compressed_train_step(cfg, opt, mesh, comp)
        p, o = placed["params"], placed["opt_state"]
        err = C.init_error_state(comp, st.params)
        q, r = st.params, st.opt_state
        params_err = []
        for batch in batches[:steps]:
            p, o, err, m = step(p, o, err, batch)
            pods = [vg(trainer.trainable(q),
                       {n: v[4 * k:4 * k + 4] for n, v in batch.items()})[0]
                    for k in range(2)]
            avg = tree_map(lambda a, b: C._div(a + b, 2), *pods)
            q, r, _ = adamw.apply_updates(opt, q, avg, r)
            params_err.append(_rel(_full(p), q))
        return params_err, err, m

    out["none"], _, _ = run("none", STEPS)
    _, err, m = run("int8", 1)
    out["int8_err_blocks"] = [list(e.shape) == list(b.shape) for e, b in
                              zip(tree_leaves(err), tree_leaves(blocks))]
    # every leaf that 'model' splits runs in its block (llama: all layers
    # parallel)
    specs = dict(__import__("repro_torch.models.common",
                            fromlist=["tree_items"]).tree_items(sh["params"]))
    out["keep_all"] = all(keep(path, 2) for path, s in specs.items()
                          if Sh.model_dim(s.spec) is not None)
    return out


def main(rank: int, world: int, init_file: str, out_dir: str, cases,
         timeout_s: float, serve_dir: str = "") -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    from repro_torch.launch.mesh import make_mesh
    results = {}
    try:
        meshes = {"2x2": make_mesh((2, 2), ("data", "model"), "cpu"),
                  "1x4": make_mesh((1, 4), ("data", "model"), "cpu"),
                  "pod": make_mesh((2, 2, 1), ("pod", "data", "model"),
                                   "cpu"),
                  "podtp": make_mesh((2, 1, 2), ("pod", "data", "model"),
                                     "cpu")}
        tmp = [tempfile.mkdtemp(dir=out_dir) if rank == 0 else None]
        dist.broadcast_object_list(tmp)
        checks = [
            ("blocks", lambda: check_blocks(meshes, cases)),
            ("step_tp", lambda: check_sharded_step(meshes, False)),
            ("step_fsdp", lambda: check_sharded_step(meshes, True)),
            ("step_moe", lambda: check_sharded_step(meshes, False,
                                                    MOE_ARCH)),
            ("compressed", lambda: check_compressed_step(meshes)),
            ("checkpoint", lambda: check_checkpoint(
                meshes, os.path.join(tmp[0], "ckpt"))),
            ("restart", lambda: check_crash_restart(
                meshes, os.path.join(tmp[0], "train"))),
            ("meshes", check_meshes),
            ("constraints", lambda: check_constraints(meshes)),
            ("layers", lambda: check_layers(meshes)),
            ("compute_shapes", lambda: check_compute_shapes(meshes)),
            ("compressed_tp", lambda: check_compressed_model_blocks(meshes)),
            ("serving", lambda: check_serving(meshes, serve_dir,
                                              timeout_s / 2))]
        walls = results["walls"] = {}
        for name, fn in checks:
            t0 = time.monotonic()
            try:
                results[name] = fn()
                walls[name] = time.monotonic() - t0
            except Exception:     # recorded per check; the test reports it
                results[name] = {"error": traceback.format_exc()}
                raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()
