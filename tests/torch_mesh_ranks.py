"""The ranks of ``tests/test_torch_mesh.py``: every multi-rank check of the
port's meshes, run by each of a few ``gloo`` ranks spawned on the CPU.

``main`` joins the group (``file://`` rendezvous, no network), runs each
check in turn on every rank (they are collective: every rank runs them in
the same order) and writes ``rank<r>.json`` with each check's result, or
the traceback it raised. Imports torch and the port only.
"""
import contextlib
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
    "seamless": ("seamless-m4t-large-v2", {}),
    "xlstm": ("xlstm-125m", {}),
}
SERVE_B, SERVE_S, SERVE_NEW, SERVE_L = 6, 8, 4, 16
# the second input of a family that takes one: the VLM's patches, the
# encoder-decoder's frames
CTX_INPUT = {"vlm": "ctx", "audio": "frames"}
SERVE_MESHES = ("2x2", "1x4")
# the serving twin with the parameters placed by FSDP (the reference's
# rules with ``embed`` on 'data') on the 2 x 2 mesh
SERVE_FSDP = "2x2fsdp"
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


def _setup(arch=CFG_ARCH, **over):
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.optim import adamw
    cfg = configs.get_smoke_config(arch, **over)
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
        # this rank's error leaves: its blocks of its pod's error, each pod
        # chunk's 'data' block (the step's compression layout)
        held = tree_map(lambda t, sh: _pod_layout(t, sh.spec, mesh),
                        errs[pod], sh["params"])
        out["err_err"].append(max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(tree_leaves(err),
                                                  tree_leaves(held))))
        out["wire"].append(m["wire_bytes_pod"])
        out["want_wire"].append(sum(t.numel() + 4
                                    for t in tree_leaves(st.params)))
    return out


def _pod_layout(t, spec, mesh):
    """This rank's block of a whole leaf ``t`` as the compressed step holds
    its gradient and error: on a dim split over ('pod', 'data') the
    'data' block of each of the 'pod' chunks, on a 'model' dim the 'model'
    block (by reshaping and slicing)."""
    names = list(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    size = dict(zip(names, mesh.shape))
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in ("data", "model"):
            if a not in axes or size[a] == 1:
                continue
            outer = math.prod(size[b] for b in axes[:axes.index(a)])
            y = t.unflatten(d, (outer, size[a], -1))
            t = y.select(d + 1, coord[a]).flatten(d, d + 1)
    return t


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


@contextlib.contextmanager
def _no_dtensor_collectives():
    """``DTensor.full_tensor`` and ``DTensor.redistribute`` patched to
    raise; yields the list of the names called."""
    from torch.distributed.tensor import DTensor
    called = []
    saved = DTensor.full_tensor, DTensor.redistribute

    def refuse(name):
        def fn(*a, **k):
            called.append(name)
            raise AssertionError(f"DTensor.{name} on a mesh path")
        return fn

    DTensor.full_tensor = refuse("full_tensor")
    DTensor.redistribute = refuse("redistribute")
    try:
        yield called
    finally:
        DTensor.full_tensor, DTensor.redistribute = saved


def _gathered_bytes(placed, n_dp):
    """``(largest block, largest unstacked leaf, whole 'model' shard)``:
    the bytes a rank gathers over 'data' for one step of a stage (its
    blocks of every stacked leaf the DP axes split) and for the largest
    unstacked such leaf, and the bytes of its 'model' shard whole over
    'data' (every leaf)."""
    from repro_torch.models.common import tree_items
    blocks, unstacked, shard = {}, 0, 0
    for path, t in tree_items(placed):
        loc = t.to_local()
        split = any(p.is_shard() and n == "data" for n, p in
                    zip(t.device_mesh.mesh_dim_names, t.placements))
        n = loc.numel() * loc.element_size() * (n_dp if split else 1)
        shard += n
        if not split:
            continue
        if path[0].startswith("stage"):
            blocks[path[0]] = blocks.get(path[0], 0) + n // t.shape[0]
        else:
            unstacked = max(unstacked, n)
    return max(blocks.values()), unstacked, shard


def check_fsdp_gathers(meshes, ckpt_dir):
    """The 2 x 2 FSDP step's gathers over 'data': one step counted by the
    dry-run (``dryrun.count``: its all-gathers and reduce-scatters, the DP
    gathers' alone in the smoke llama's step) beside the step's
    ``DPGather`` counts and its high-water mark of live gathered bytes
    against :func:`_gathered_bytes`; then with ``DTensor.full_tensor`` and
    ``redistribute`` refused (:func:`_no_dtensor_collectives`): a second
    step on a DTensor batch (against the one-device step), a checkpoint
    save of its state
    (read back whole) and a mesh-engine prefill and decode with
    FSDP-placed parameters (against the meshless engine's tokens)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import dryrun
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import get_model
    from repro_torch.parallel import sharding as Sh
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.train import trainer
    cfg, opt, batches = _setup()
    mesh = meshes["2x2"]
    st = trainer.init_train_state(cfg, opt, 0, "cpu")
    sh = trainer.state_shardings(cfg, mesh, fsdp=True)
    placed = trainer.shard_state({"params": st.params,
                                  "opt_state": st.opt_state},
                                 {"params": sh["params"],
                                  "opt_state": sh["opt_state"]})
    step = trainer.make_train_step(cfg, opt, mesh, fsdp=True)
    one = trainer.make_train_step(cfg, opt)
    gather = step.pieces["mesh_step"].gather
    gather.reset()
    got = {}

    def first():
        got["state"] = step(placed["params"], placed["opt_state"],
                            batches[0])
        return got["state"][0]

    c = dryrun.count(first)["collectives"]
    counts = gather.counts()
    block, unstacked, shard = _gathered_bytes(placed["params"], 2)
    out = {"dryrun": {k: c[k] for k in ("all-gather", "reduce-scatter")},
           "gather": counts, "live_after": gather.live_bytes,
           "block": block, "unstacked": unstacked, "shard": shard}
    q, r, _ = one(st.params, st.opt_state, batches[0])
    q, r, n = one(q, r, batches[1])
    mgr = CheckpointManager(ckpt_dir)
    # the second step's batch as DTensors placed by batch_shardings: the
    # step takes each rank's rows as their local blocks
    placed_batch = {k: Sh.distribute(v, sh_b) for (k, v), sh_b in zip(
        batches[1].items(), Sh.batch_shardings(batches[1], mesh).values())}
    with _no_dtensor_collectives() as called:
        p, o, m = step(*got["state"][:2], placed_batch)
        mgr.save(1, {"params": p}, block=True)
        model = get_model(cfg)
        shapes, axes = model.init(0, device="meta", with_axes=True)
        fsdp = trainer.shard_state(st.params, Sh.param_shardings(
            axes, shapes, mesh, Sh.make_rules(fsdp=True,
                                              data_axes=("data",))))
        prompts = batches[0]["tokens"][:, :SERVE_S]
        scfg = ServeConfig(B, SERVE_L)
        eng = ServingEngine(cfg, scfg, params=fsdp, device="cpu", mesh=mesh)
        tokens = eng.generate(prompts, SERVE_NEW)
        eng._mesh.gather.reset()
        logits, cache = eng.prefill(prompts)
        eng.decode(torch.from_numpy(tokens[:, :1]), cache, SERVE_S)
        want = ServingEngine(cfg, scfg, params=st.params,
                             device="cpu").generate(prompts, SERVE_NEW)
        out["decode"] = {"tokens_equal": bool((tokens == want).all()),
                         "gathers": eng._mesh.gather.gathers,
                         "split": len(eng._mesh.gather.splits)}
    out["dtensor_calls"] = called
    out["train"] = {"loss_rel": abs(float(m["loss"]) - float(n["loss"]))
                    / abs(float(n["loss"])), "params_rel": _rel(_full(p), q)}
    back = mgr.restore(1, {"params": q})
    out["save"] = {"same": _same(back["params"], _full(p)),
                   "steps": mgr.all_steps()}
    out["held"] = sum(t.to_local().numel() for t in tree_leaves(p)) \
        / sum(t.numel() for t in tree_leaves(q))
    return out


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
    from repro_torch.parallel import sharding as Sh
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.train import trainer
    deadline = time.monotonic() + timeout_s
    inputs = _load(serve_dir, "inputs", deadline)
    prompts = torch.from_numpy(inputs["prompts"])
    out = {}
    for name, (arch, over) in SERVE_CASES.items():
        cfg = configs.get_smoke_config(arch, **over, **F32)
        params = weights.from_reference(_load(serve_dir, arch, deadline),
                                        "cpu")
        ctx = (torch.from_numpy(inputs[CTX_INPUT[cfg.family]])
               if cfg.family in CTX_INPUT else None)
        sdims = sequence_dims(cfg)
        full = dict(_leaves(get_model(cfg).init_cache(SERVE_B, SERVE_L,
                                                      device="meta")))
        for mesh_name in SERVE_MESHES + (SERVE_FSDP,):
            fsdp = mesh_name == SERVE_FSDP
            mesh = meshes["2x2" if fsdp else mesh_name]
            coord = tuple(mesh.get_coordinate())
            tp = mesh.shape[mesh.mesh_dim_names.index("model")]
            placed = params
            if fsdp:
                shapes, axes = get_model(cfg).init(0, device="meta",
                                                   with_axes=True)
                placed = trainer.shard_state(params, Sh.param_shardings(
                    axes, shapes, mesh, Sh.make_rules(
                        fsdp=True, data_axes=Sh.dp_axes(mesh))))
            eng = ServingEngine(cfg, ServeConfig(SERVE_B, SERVE_L),
                                params=placed, device="cpu", mesh=mesh)
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
            gather = eng._mesh.gather
            for i in range(SERVE_NEW - 1):
                tok = torch.from_numpy(tokens[:, i:i + 1])
                comm = CommDebugMode()
                gather.reset()
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
                "decode_gathers": gathers, "dp_gathers": gather.gathers,
                "dp_split": len(gather.splits)}
    return out



# ------------------------------------------------------------ TP and EP

LAYER_B, LAYER_S, LAYER_L = 3, 8, 16     # rows, prompt, cache entries
LAYER_VOCAB = 120                        # pads to 256: masked columns
GRAD_FLOOR = 0.1       # the new twins' gradients: see _twin


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


def _cut(t, axes, mg):
    """The index of this rank's block of ``t`` where the reference's rules
    split it over a 'model' axis of ``mg.size`` ranks, else the whole."""
    from repro_torch.parallel import sharding as Sh
    d = Sh.model_dim(Sh.spec_for_axes(axes, tuple(t.shape), Sh.MeshShape(
        ("model",), (mg.size,)), Sh.make_rules()))
    return (slice(None),) if d is None \
        else (slice(None),) * d + (mg.block(t.shape[d]),)


def _split(mg, params, axes):
    """``(whole, local, cuts)``: the whole leaves and this rank's blocks of
    them (:func:`_cut`), each a leaf that requires grad."""
    from repro_torch.models.common import tree_map
    cuts = tree_map(lambda t, a: _cut(t, a, mg), params, axes)
    whole = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    local = tree_map(lambda t, c: t.detach()[c].clone().requires_grad_(),
                     params, cuts)
    return whole, local, cuts


def _twin(mg, params, axes, fwd, inputs):
    """``fwd(p, *inputs)`` (a tensor) on the whole leaves and, under
    ``mg``, on this rank's blocks: the output's and the gradients' largest
    relative difference (the inputs', and each leaf's against the whole
    leaf's gradient cut to its block), and ``(whole, local, cuts)``."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as Sh
    whole, local, cuts = _split(mg, params, axes)
    xw = [x.detach().clone().requires_grad_() for x in inputs]
    xl = [x.detach().clone().requires_grad_() for x in inputs]
    want = fwd(whole, *xw)
    gw = _grads(want, xw + tree_leaves(whole))
    with Sh.model_parallel(mg):
        got = fwd(local, *xl)
        gg = _grads(got, xl + tree_leaves(local))
    n = len(inputs)
    pairs = list(zip(gg[:n], gw[:n])) + [
        (g, w[c]) for g, w, c in zip(gg[n:], gw[n:], tree_leaves(cuts))]
    # each gradient against its own norm, floored at GRAD_FLOOR of all
    # the gradients' norm: a gate bias's gradient sums per-token terms that
    # all but cancel (the sLSTM's input gate exactly: a common shift of log
    # i cancels in c / n), so its rounding is that of the terms, not of
    # the sum
    floor = GRAD_FLOOR * math.sqrt(sum(float(w.double().square().sum())
                                       for _, w in pairs))
    grads = max(float((g.double() - w.double()).norm())
                / max(float(w.double().norm()), floor) for g, w in pairs)
    return (_rel_max([(got.detach(), want.detach())]), grads,
            (whole, local, cuts))


def _no_grad(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.detach(), tree)


def twin_mla(mg, gen, absorbed):
    """``apply_mla`` (plain or absorbed) with its heads split against the
    whole layer: the prefill's output and gradients, then one decode step
    over a sequence-split latent cache block (every head over the block,
    combined across 'model') and the blocks written."""
    from repro_torch.models import attention as A
    from repro_torch.parallel import sharding as Sh
    D, H = 64, 4
    dims = dict(kv_rank=32, d_nope=16, d_rope=8, d_v=16)
    params, axes = A.init_mla(gen, D, H, q_rank=48, dtype=torch.float32,
                              **dims)
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)
    pos = torch.arange(LAYER_S)
    kw = dict(absorbed=absorbed, **dims)

    def fwd(p, xs):
        return A.apply_mla(p, xs, positions=pos, n_heads=H, **kw)[0]

    prefill, grads, (whole, local, _) = _twin(mg, params, axes, fwd,
                                              [x[:, :LAYER_S]])
    whole, local = _no_grad(whole), _no_grad(local)
    shapes = ((LAYER_B, LAYER_L, dims["kv_rank"]),
              (LAYER_B, LAYER_L, dims["d_rope"]))
    cache = [torch.zeros(s) for s in shapes]
    n = LAYER_L // mg.size
    blk = Sh.CacheBlock(mg.index * n, (mg.index + 1) * n, mg.group)
    block = [torch.zeros((LAYER_B, n, s[2])) for s in shapes]
    step = torch.tensor([LAYER_S])
    with torch.no_grad():
        A.apply_mla(whole, x[:, :LAYER_S], positions=pos, cache=cache, **kw)
        want, _ = A.apply_mla(whole, x[:, LAYER_S:], positions=step,
                              cache=cache, cache_pos=LAYER_S, **kw)
        with Sh.model_parallel(mg), Sh.cache_block(blk):
            A.apply_mla(local, x[:, :LAYER_S], positions=pos, cache=block,
                        n_heads=H, **kw)
            got, _ = A.apply_mla(local, x[:, LAYER_S:], positions=step,
                                 cache=block, cache_pos=LAYER_S, n_heads=H,
                                 **kw)
    cached = max(float((b - c[:, blk.start:blk.stop]).abs().max())
                 / float(c.abs().max()) for b, c in zip(block, cache))
    return {"prefill": prefill, "prefill_grads": grads,
            "decode": _rel_max([(got, want)]), "cache": cached}


def twin_cross(mg, gen):
    """``apply_cross`` with its heads split (the 2 KV heads split on 2
    ranks, whole on 4) against the whole layer: the output and the
    gradients of x, ctx and the blocks, then a decode step from the K/V it
    returned (this rank's KV heads, as the cache keeps them)."""
    from repro_torch.models import attention as A
    from repro_torch.parallel import sharding as Sh
    D, H, Hkv, hd, Dc, T = 64, 4, 2, 16, 48, 6
    params, axes = A.init_cross(gen, D, H, Hkv, hd, Dc, torch.float32)
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)
    ctx = torch.randn((LAYER_B, T, Dc), generator=gen)

    def fwd(p, xs, c):
        return A.apply_cross(p, xs, c, n_heads=H, n_kv_heads=Hkv)[0]

    out, grads, (whole, local, cuts) = _twin(mg, params, axes, fwd,
                                             [x[:, :LAYER_S], ctx])
    whole, local = _no_grad(whole), _no_grad(local)
    with torch.no_grad():
        _, kv_w = A.apply_cross(whole, x[:, :LAYER_S], ctx)
        want, _ = A.apply_cross(whole, x[:, LAYER_S:], kv_cache=kv_w)
        with Sh.model_parallel(mg):
            _, kv_l = A.apply_cross(local, x[:, :LAYER_S], ctx, n_heads=H,
                                    n_kv_heads=Hkv)
            got, _ = A.apply_cross(local, x[:, LAYER_S:], kv_cache=kv_l,
                                   n_heads=H, n_kv_heads=Hkv)
    kv = cuts["wk"][1] if mg.splits(Hkv) else slice(None)
    return {"prefill": out, "prefill_grads": grads,
            "decode": _rel_max([(got, want)]),
            "cache": _rel_max([(a, b[:, :, kv]) for a, b in zip(kv_l, kv_w)]),
            "kv_split": mg.splits(Hkv)}


def twin_encoder(mg, gen):
    """The smoke seamless encoder (non-causal GQA self-attention and
    SwiGLU, two layers) on this rank's blocks of every leaf the
    reference's rules split against the whole encoder: the output and the
    gradients of the frames and of every leaf."""
    from repro_torch import configs
    from repro_torch.models.transformer import get_model
    cfg = configs.get_smoke_config("seamless-m4t-large-v2", **F32)
    model = get_model(cfg)
    params, axes = model.init(5, device="cpu", with_axes=True)
    frames = torch.randn((LAYER_B, LAYER_S, cfg.d_model), generator=gen)
    keep = ("encoder", "ln_enc")
    out, grads, _ = _twin(
        mg, {k: params[k] for k in keep}, {k: axes[k] for k in keep},
        lambda p, f: model.encode(p, f), [frames])
    return {"out": out, "grads": grads}


def twin_mamba(mg, gen):
    """``apply_mamba2`` on this rank's heads (the fused projection's
    column block gathered, the conv leaves gathered, the norm's squares
    summed, ``w_out`` row-parallel) against the whole mixer: the
    full-sequence output and gradients (the plain scan), again over more
    tokens than ``d_model`` (``w_in``'s block gathered, this rank's
    columns projected, the conv state made whole from the last tokens'
    inputs) with its states, then a prefill
    from no state through ``mamba2_scan`` on the local heads and one
    decode step from its state: outputs, the SSM state's head block and
    the whole conv state."""
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding as Sh
    D, N, P = 64, 16, 16
    H = 2 * D // P
    params, axes = ssm.init_mamba2(gen, D, N, P, 2, 4, torch.float32)
    # non-zero conv biases and dt biases, so their gradients are
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
              if k in ("conv_b", "dt_bias") else v for k, v in params.items()}
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)
    kw = dict(d_state=N, head_dim=P, chunk=4, n_heads=H)

    def fwd(p, xs):
        return ssm.apply_mamba2(p, xs, **kw)[0]

    out, grads, (whole, local, _) = _twin(mg, params, axes, fwd,
                                          [x[:, :LAYER_S]])
    # more tokens than d_model: w_in's block gathered, not the projection
    xl = torch.randn((LAYER_B, 3 * LAYER_S, D), generator=gen)
    long, long_grads, _ = _twin(mg, params, axes, fwd, [xl])
    whole, local = _no_grad(whole), _no_grad(local)
    fresh = {"conv": None, "ssm": None}
    kw["impl"] = "mamba_kernel"
    with torch.no_grad():
        # the long prefill's states: this rank's heads, the whole conv
        _, lw = ssm.apply_mamba2(whole, xl, state=fresh, **kw)
        with Sh.model_parallel(mg):
            _, ll = ssm.apply_mamba2(local, xl, state=fresh, **kw)
        yw, sw = ssm.apply_mamba2(whole, x[:, :LAYER_S], state=fresh, **kw)
        want, stw = ssm.apply_mamba2(whole, x[:, LAYER_S:], state=sw, **kw)
        with Sh.model_parallel(mg):
            yl, sl = ssm.apply_mamba2(local, x[:, :LAYER_S], state=fresh,
                                      **kw)
            got, stl = ssm.apply_mamba2(local, x[:, LAYER_S:], state=sl,
                                        **kw)
    hb = mg.block(H)
    return {"prefill": out, "prefill_grads": grads, "long": long,
            "long_grads": long_grads,
            "kernel_prefill": _rel_max([(yl, yw)]),
            "decode": _rel_max([(got, want)]),
            "state": _rel_max([(stl["ssm"], stw["ssm"][:, hb]),
                               (stl["conv"], stw["conv"]),
                               (ll["ssm"], lw["ssm"][:, hb]),
                               (ll["conv"], lw["conv"])]),
            "local_heads": int(sl["ssm"].shape[1])}


def twin_mlstm(mg, gen):
    """``apply_mlstm`` on this rank's heads against the whole cell: the
    chunkwise form's output and gradients, then one step from its state:
    the output and the state's head blocks."""
    from repro_torch.models import xlstm
    from repro_torch.parallel import sharding as Sh
    D, H = 64, 4
    params, axes = xlstm.init_mlstm(gen, D, H, torch.float32)
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)

    def fwd(p, xs):
        return xlstm.apply_mlstm(p, xs, q_chunk=4, n_heads=H)[0]

    out, grads, (whole, local, _) = _twin(mg, params, axes, fwd,
                                          [x[:, :LAYER_S]])
    return {"prefill": out, "prefill_grads": grads,
            **_state_step(mg, H, xlstm.apply_mlstm, _no_grad(whole),
                          _no_grad(local), x)}


def _state_step(mg, H, apply, whole, local, x):
    """A recurrent cell's state after ``x[:, :LAYER_S]`` and one step
    from it, whole and on this rank's heads: the step's output and the
    new state's head blocks (dim 1 of each leaf)."""
    from repro_torch.parallel import sharding as Sh
    with torch.no_grad():
        _, sw = apply(whole, x[:, :LAYER_S])
        want, stw = apply(whole, x[:, LAYER_S:], sw)
        with Sh.model_parallel(mg):
            _, sl = apply(local, x[:, :LAYER_S], n_heads=H)
            got, stl = apply(local, x[:, LAYER_S:], sl, n_heads=H)
    hb = mg.block(H)
    return {"decode": _rel_max([(got, want)]),
            "state": max(float((stl[k] - stw[k][:, hb]).abs().max())
                         / float(stw[k].abs().max()) for k in stw)}


def twin_slstm(mg, gen):
    """``apply_slstm`` on this rank's heads (their ``h`` gathered before
    the whole norm and ``w_out``) against the whole cell: the output and
    gradients, then one step from its state."""
    from repro_torch.models import xlstm
    D, H = 64, 4
    params, axes = xlstm.init_slstm(gen, D, H, torch.float32)
    x = torch.randn((LAYER_B, LAYER_S + 1, D), generator=gen)

    def fwd(p, xs):
        return xlstm.apply_slstm(p, xs, n_heads=H)[0]

    out, grads, (whole, local, _) = _twin(mg, params, axes, fwd,
                                          [x[:, :LAYER_S]])
    return {"prefill": out, "prefill_grads": grads,
            **_state_step(mg, H, xlstm.apply_slstm, _no_grad(whole),
                          _no_grad(local), x)}


def twin_seq_split(mg, gen):
    """``apply_gqa`` with 6 query heads and 2 KV heads (a smoke GQA layer
    whose heads a 'model' axis of 4 does not divide: the layer runs whole
    and the query's sequence splits over 'model'; on 2 the heads split)
    against the whole layer: the output and the gradients of x and of the
    leaves."""
    from repro_torch.models import attention as A
    from repro_torch.parallel import sharding as Sh
    D, H, Hkv, hd = 64, 6, 2, 16
    params, axes = A.init_gqa(gen, D, H, Hkv, hd, torch.float32)
    x = torch.randn((LAYER_B, LAYER_S, D), generator=gen)
    pos = torch.arange(LAYER_S)

    def fwd(p, xs):
        return A.apply_gqa(p, xs, positions=pos, n_heads=H,
                           n_kv_heads=Hkv)[0]

    out, grads, _ = _twin(mg, params, axes, fwd, [x])
    with Sh.model_parallel(mg):
        split = Sh.seq_split_group(H, LAYER_S) is not None
    return {"out": out, "grads": grads, "seq_split": split}


def twin_expert_width(mg, gen):
    """The smoke maverick's MoE layer with 6 experts (top 1, a shared
    expert; a 'model' axis of 4 does not divide the experts, so each
    expert runs on this rank's block of its width, column- then
    row-parallel; on 2 the experts split) against the whole layer: the
    output plus the load-balance loss, and the gradients."""
    from repro_torch.models import moe
    D, E, Fd, k = 64, 6, 64, 1
    params, axes = moe.init_moe(gen, D, Fd, E, 1, Fd, torch.float32, "cpu")
    x = torch.randn((LAYER_B, LAYER_S, D), generator=gen)
    kw = dict(top_k=k, n_experts=E, capacity_factor=1.25, shared_width=Fd,
              expert_width=Fd)

    def fwd(p, xs):
        y, aux = moe.apply_moe(p, xs, **kw)
        return y + aux["load_balance_loss"]

    out, grads, (_, local, _) = _twin(mg, params, axes, fwd, [x])
    return {"out": out, "grads": grads,
            "expert_shape": list(local["w_gate"].shape)}


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
                          "moe": twin_moe(mg, gen),
                          "mla": twin_mla(mg, gen, False),
                          "mla_absorbed": twin_mla(mg, gen, True),
                          "cross": twin_cross(mg, gen),
                          "encoder": twin_encoder(mg, gen),
                          "mamba": twin_mamba(mg, gen),
                          "mlstm": twin_mlstm(mg, gen),
                          "slstm": twin_slstm(mg, gen),
                          "seq_split": twin_seq_split(mg, gen),
                          "expert_width": twin_expert_width(mg, gen)}
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


# name -> (arch, overrides): the smoke configs, and two whose 'model' axis
# of 4 divides neither the heads (6: the query's sequence splits) nor the
# experts (6: each expert's width splits)
COMPUTE_ARCHS = {**{a: (a, {}) for a in (
    CFG_ARCH, MOE_ARCH, "zamba2-1.2b", "seamless-m4t-large-v2",
    "xlstm-125m")},
    "gqa-6-heads": (CFG_ARCH, {"n_heads": 6}),
    "maverick-6-experts": ("llama4-maverick-400b-a17b", {"n_experts": 6})}


def check_compute_shapes(meshes):
    """The shapes the sharded step and the serving engine compute on, for
    the smoke llama, deepseek (MLA, EP), zamba2 (Mamba and the shared
    block), seamless (the encoder, cross-attention), the xLSTM, the smoke
    llama with 6 heads and the smoke maverick with 6 experts, on both
    meshes."""
    from repro_torch import configs
    from repro_torch.models.transformer import (get_model,
                                                model_parallel_leaf)
    from repro_torch.parallel import sharding as Sh
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.train import trainer
    out = {}
    for name, (arch, over) in COMPUTE_ARCHS.items():
        cfg, opt, _ = _setup(arch, **over)
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
            out[f"{name}-{mesh_name}"] = {
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
            ("fsdp_gathers", lambda: check_fsdp_gathers(
                meshes, os.path.join(tmp[0], "fsdp"))),
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
