"""The port's meshes on four ``gloo`` ranks on the CPU: sharded placement
against the reference's ``NamedSharding``, the sharded and compressed
training steps, restoring across meshes, the crash-restart loop, the
serving engine on the 2 x 2 and 1 x 4 meshes (and on 2 x 2 with
parameters placed by FSDP), tensor and expert parallelism on 'model':
each parallel layer against the whole layer (the query's sequence split
and a routed expert's width among them), the shapes the step and the
engine compute on, and the compressed step's 'model' blocks; and the FSDP
step's DP gathers: one block at a time, counted as the dry-run counts
them, with no DTensor collective on the step, a save or a decode.

One group of 4 ranks, spawned once for the whole file
(``tests/torch_mesh_ranks.py`` runs every check on every rank), joins
under its own timeout, so that a hang fails these tests instead of holding
the run. The reference's blocks come from
``NamedSharding.devices_indices_map`` in a subprocess with 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), so this
worker's JAX is not touched.

Tolerances: the sharded step averages two ranks' half-batch gradients
where the one-device step takes the whole batch at once, so its losses
agree within 1e-6 relative and its parameters within 1e-5 of their norm.
The compressed step is held against its emulation in one process, which
runs the same operations on the same rows: within 1e-6. Checkpoints
restore bit for bit.

Serving: each family's smoke config in f32 with the reference's weights
(``jax.random.PRNGKey(0)``, drawn in this process once the ranks are
spawned, while they run the other checks, and pickled for them arch by
arch). The reference's meshless ``ServingEngine`` runs here meanwhile. Greedy tokens are equal;
each rank's rows' logits are within 1e-5 of each row's norm (the ranks
sum the sequence blocks' softmaxes and route on their own rows in other
orders than the one-device reference: about 1e-7 relative).
"""
import dataclasses
import json
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import pytest

import torch_mesh_ranks as R

WORLD = 4
JOIN_TIMEOUT_S = 180.0
LOGIT_ROW_REL = 1e-5

_REF_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.load(sys.stdin)
out = []
for c in cases:
    devs = np.array(jax.devices()[:int(np.prod(c["sizes"]))])
    mesh = Mesh(devs.reshape(c["sizes"]), tuple(c["names"]))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in c["spec"]])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(c["shape"]))
    blocks = []
    for d in devs.reshape(-1):       # row-major over the mesh coordinates
        blocks.append([[s.start or 0, n if s.stop is None else s.stop]
                       for s, n in zip(idx[d], c["shape"])])
    out.append(blocks)
json.dump(out, sys.stdout)
"""

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod": ((2, 2, 1), ("pod", "data", "model"))}


def block_cases():
    """A few leaves of the smoke llama's FSDP shardings on both meshes,
    and its train batch: entries None, 'data', 'model' and ('pod',
    'data')."""
    from repro_torch import configs
    from repro_torch.models.common import tree_items
    from repro_torch.parallel import sharding as Sh
    from repro_torch.train import trainer
    cfg = configs.get_smoke_config(R.CFG_ARCH)
    shapes, _ = configs.param_specs(cfg)
    cases = []
    for mesh_name, (sizes, names) in MESHES.items():
        mesh = Sh.MeshShape(names, sizes)
        sh = dict(tree_items(trainer.state_shardings(cfg, mesh,
                                                     fsdp=True)["params"]))
        shp = dict(tree_items(shapes))
        for path in [("embed",), ("ln_f",), ("stage0", "attn", "wq"),
                     ("stage0", "ffn", "w_down"), ("stage0", "ln1")]:
            cases.append(dict(name=f"{mesh_name}:{'/'.join(path)}",
                              mesh=mesh_name, sizes=sizes, names=names,
                              shape=list(shp[path].shape),
                              spec=list(sh[path].spec)))
        tok = Sh.batch_shardings({"t": shp[("embed",)].new_empty(
            (R.B, R.S))}, mesh)["t"]
        cases.append(dict(name=f"{mesh_name}:tokens", mesh=mesh_name,
                          sizes=sizes, names=names, shape=[R.B, R.S],
                          spec=list(tok.spec)))
    return cases


def _dump(out, name, obj):
    """Pickles ``obj`` for the ranks under ``R.serve_file(name)``, whole
    before it appears."""
    tmp = out / (R.serve_file(name) + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, out / R.serve_file(name))


def reference_weights(arch):
    """The reference's smoke weights of ``arch`` in f32, a numpy tree."""
    import jax
    from repro import configs as jconfigs
    from repro.models.transformer import get_model as jget_model
    model = jget_model(dataclasses.replace(jconfigs.get_smoke_config(arch),
                                           **R.F32))
    tree = jax.jit(lambda k: model.init(k)[0])(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def write_serve_inputs(out):
    """The prompts, the VLM's ``ctx`` and the encoder-decoder's frames
    (from seeds), then each serving
    arch's reference weights (MLA's two cases share one; drawn in threads)
    as each is drawn, pickled for the ranks; returns all of them."""
    from repro import configs as jconfigs
    rng = np.random.default_rng(3)
    vlm = jconfigs.get_smoke_config("llama-3.2-vision-90b")
    audio = jconfigs.get_smoke_config("seamless-m4t-large-v2")
    inputs = {"prompts": rng.integers(0, 128, (R.SERVE_B, R.SERVE_S))
              .astype(np.int32),
              "ctx": rng.standard_normal((R.SERVE_B, vlm.n_ctx, vlm.d_ctx))
              .astype(np.float32),
              "frames": rng.standard_normal(
                  (R.SERVE_B, audio.n_ctx, audio.d_model)).astype(np.float32)}
    _dump(out, "inputs", inputs)
    archs = list(dict.fromkeys(a for a, _ in R.SERVE_CASES.values()))
    params = {}
    with ThreadPoolExecutor(len(archs)) as ex:
        futs = {ex.submit(reference_weights, a): a for a in archs}
        for f in as_completed(futs):
            params[futs[f]] = f.result()
            _dump(out, futs[f], params[futs[f]])
    return dict(inputs, params=params)


def serve_reference(inputs):
    """The reference's meshless engine on each case: greedy tokens, and the
    last position's logits of the prefill and of each decode step."""
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.serving.engine import ServeConfig, ServingEngine
    out = {}
    for name, (arch, over) in R.SERVE_CASES.items():
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over,
                                  **R.F32)
        eng = ServingEngine(cfg, ServeConfig(R.SERVE_B, R.SERVE_L),
                            params=inputs["params"][arch])
        ctx = (jnp.asarray(inputs[R.CTX_INPUT[cfg.family]])
               if cfg.family in R.CTX_INPUT else None)
        logits, cache = eng.prefill(jnp.asarray(inputs["prompts"]), ctx)
        steps, toks = [], []
        for i in range(R.SERVE_NEW):
            steps.append(np.asarray(logits[:, -1], np.float64))
            toks.append(np.argmax(steps[-1], -1).astype(np.int32))
            if i < R.SERVE_NEW - 1:
                logits, cache = eng.decode(jnp.asarray(toks[-1][:, None]),
                                           cache, jnp.int32(R.SERVE_S + i))
        out[name] = {"tokens": np.stack(toks, 1), "logits": steps}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, by rank, and under ``"reference"`` the
    reference's serving outputs."""
    cases = block_cases()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", _REF_BLOCKS],
                         input=json.dumps(cases), capture_output=True,
                         text=True, env=env, timeout=JOIN_TIMEOUT_S,
                         check=True)
    for case, blocks in zip(cases, json.loads(ref.stdout)):
        case["blocks"] = blocks
    out = tmp_path_factory.mktemp("mesh_ranks")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=R.main, args=(
        r, WORLD, str(out / "rendezvous"), str(out), cases,
        JOIN_TIMEOUT_S - 30.0, str(out))) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.start()
    # the ranks run the other checks meanwhile
    reference = serve_reference(write_serve_inputs(out))
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    results = {}
    for r in range(WORLD):
        path = out / f"rank{r}.json"
        results[r] = json.loads(path.read_text()) if path.exists() else {}
    if hung:
        pytest.fail(f"{len(hung)} of {WORLD} ranks still ran after "
                    f"{JOIN_TIMEOUT_S:.0f} s; results {results}")
    results["reference"] = reference
    return results


def result(ranks, name):
    """Check ``name``'s result on every rank; a rank that raised fails."""
    out = []
    for r in range(WORLD):
        got = ranks[r].get(name)
        assert got is not None, f"rank {r} has no {name!r} result"
        assert not (isinstance(got, dict) and "error" in got), \
            f"rank {r}:\n{got['error']}"
        out.append(got)
    return out


def test_local_blocks_equal_reference_devices_indices_map(ranks):
    per_rank = result(ranks, "blocks")
    coords = {tuple(c["coord"]) for blocks in per_rank for c in blocks
              if c["name"].startswith("pod:")}
    assert coords == {(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)}
    for blocks in per_rank:
        assert len(blocks) == 12
        for c in blocks:
            assert c["local"] and c["block"], c


@pytest.mark.parametrize("mode", ["tp", "fsdp", "moe"])
def test_sharded_step_matches_one_device_step(ranks, mode):
    for got in result(ranks, f"step_{mode}"):
        assert got["steps"] == R.STEPS
        for a, b in zip(got["losses"], got["want"]):
            assert abs(a - b) <= 1e-6 * abs(b), got
        assert got["params_rel"] < 1e-5, got
        assert got["moments_rel"] < 1e-4, got


def test_fsdp_holds_a_quarter_of_the_state(ranks):
    tp = result(ranks, "step_tp")
    fsdp = result(ranks, "step_fsdp")
    for a, b in zip(tp, fsdp):
        # 'model' shards the heads, MLP and vocab; FSDP adds 'data' on
        # every embed dim: 1/(data * model) but for the 1-d norms
        assert b["held"] < 0.26 and a["held"] > b["held"], (a, b)


def test_compressed_step_equals_mean_of_pod_compressed_grads(ranks):
    for got in result(ranks, "compressed"):
        assert max(got["params_err"]) <= 1e-6, got
        assert max(got["err_err"]) <= 1e-6, got
        for a, b in zip(got["loss"], got["want_loss"]):
            assert abs(a - b) <= 1e-6 * abs(b), got
        assert got["wire"] == got["want_wire"]


def test_checkpoint_restores_across_meshes_bit_for_bit(ranks):
    for got in result(ranks, "checkpoint"):
        assert got == {"onto_mesh": True, "placements": True,
                       "onto_no_mesh": True, "steps": [5]}


def test_crash_restart_resumes_on_a_mesh(ranks):
    for got in result(ranks, "restart"):
        assert got == {"restarts": [1, 0], "restored_from": [2],
                       "same": True}


def test_debug_and_production_meshes(ranks):
    for got in result(ranks, "meshes"):
        assert got["debug"] == [["data", "model"], [1, 4]]
        assert "256" in got["production"] and "4" in got["production"]


def test_constraints_redistribute_a_dtensor(ranks):
    for got in result(ranks, "constraints"):
        assert got["kv"] == ["S(0)", "S(1)"]
        assert got["q"] == ["S(0)", "R"]
        assert got["seq_q"] == ["S(0)", "S(1)"]
        assert got["values"]


SERVE_IDS = [f"{c}-{m}" for c in R.SERVE_CASES for m in R.SERVE_MESHES]
FSDP_SERVE_IDS = [f"{c}-{R.SERVE_FSDP}" for c in R.SERVE_CASES]
MESH_SHAPES = {"2x2": ((2, 2), ("data", "model")),
               "1x4": ((1, 4), ("data", "model"))}


def serving(ranks, case_mesh):
    """Every rank's serving result of one case on one mesh."""
    return [got[case_mesh] for got in result(ranks, "serving")]


@pytest.mark.parametrize("case_mesh", SERVE_IDS + FSDP_SERVE_IDS)
def test_mesh_engine_equals_reference_engine(ranks, case_mesh):
    """Greedy tokens equal to the reference's meshless engine on every
    rank; each rank's rows' logits within 1e-5 of each row's norm. On
    ``2x2fsdp`` the parameters are placed by the FSDP rules (``embed`` on
    'data'): the engine keeps its blocks and gathers them over 'data' at
    each use (some leaves split, some gathers in a decode step)."""
    want = ranks["reference"][case_mesh.split("-")[0]]
    for got in serving(ranks, case_mesh):
        if case_mesh.endswith(R.SERVE_FSDP):
            assert got["dp_split"] > 0 and got["dp_gathers"] > 0, got
        else:
            assert got["dp_split"] == 0 and got["dp_gathers"] == 0, got
        np.testing.assert_array_equal(np.asarray(got["tokens"]),
                                      want["tokens"])
        for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            w = w[got["rows"]]
            rel = np.linalg.norm(np.asarray(g) - w, axis=-1) \
                / np.linalg.norm(w, axis=-1)
            assert rel.max() <= LOGIT_ROW_REL, (step, rel)


def gqa_layers_per_token(cfg, model) -> int:
    """The GQA self-attention layers one decode step runs: a decoder's
    self blocks (none under MLA; a VLM's cross blocks are not GQA), the
    hybrid's shared block once per super block, the encoder-decoder's
    decoder layers, none in the xLSTM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return 0 if cfg.use_mla else model.n_super
    if cfg.family == "audio":
        return cfg.n_dec_layers
    if cfg.use_mla:
        return 0
    per = {"dense": lambda inner: 1, "moe": lambda inner: 1,
           "moe_super": lambda inner: inner + 1,
           "vlm_super": lambda inner: inner}
    return sum(n * per[kind](inner) for kind, n, inner in model.plan)


def expected_decode_gathers(case, mesh_name):
    """The all-gathers of one decode step by the engine's design, every
    layer on this rank's 'model' block: per cache leaf whose 'model' dim
    at rest (the reference's shardings) is not the head dim its layer
    computes split, one gather to move it for the step where it rests
    split and one to move it back where the layer splits it (the smoke
    hybrid's SSM state: the reference's rule takes its P = 16 for the
    16-entry sequence), none of a sequence-sharded or head-split leaf (a
    cross cache, a Mamba or xLSTM state); on a mesh whose DP ranks split the
    batch, one per MoE layer (its routing's per-expert counts); with the
    heads split over 'model', per GQA layer the new token's query heads
    and, where the KV heads split too, its keys and values, per MLA layer
    the query heads (absorbed: folded into the latent, with the RoPE part)
    and, plain, ``wkv_b`` to expand every head's K/V over the block, and
    per sLSTM layer its heads' output; per Mamba layer the projection's
    column block and the two conv leaves (one call), where 'model' splits
    them; and
    the logits' vocabulary blocks where the head is split. A
    cross-attention layer reads its own KV heads: nothing."""
    from repro_torch import configs
    from repro_torch.models.transformer import get_model, head_width
    from repro_torch.parallel import sharding as Sh
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    arch, over = R.SERVE_CASES[case]
    sizes, names = MESH_SHAPES[mesh_name]
    cfg = configs.get_smoke_config(arch, **over, **R.F32)
    model = get_model(cfg)
    mesh = Sh.MeshShape(names, sizes)
    eng = ServingEngine(cfg, ServeConfig(R.SERVE_B, R.SERVE_L),
                        device="cpu", mesh=mesh)
    seq = R.sequence_dims(cfg)
    full = dict(R._leaves(model.init_cache(R.SERVE_B, R.SERVE_L,
                                           device="meta")))
    with Sh.model_parallel(Sh.model_group_of(mesh, (0,) * len(sizes))):
        local = dict(R._leaves(model.init_cache(R.SERVE_B, R.SERVE_L,
                                                device="meta")))
    tp = mesh.shape["model"]
    n = 0
    for path, sh in R._leaves(eng.cache_shardings):
        model_dims = [d for d, e in enumerate(sh.spec) if e == "model"]
        heads = [d for d, (a, b) in enumerate(zip(full[path].shape,
                                                  local[path].shape))
                 if a != b]
        if path in seq:
            assert tp == 1 or model_dims == [seq[path]], (path, sh.spec)
        elif tp > 1 and model_dims != heads:
            # gathered for the step where it rests split, and gathered
            # back to rest where its layer computes on this rank's heads
            n += bool(model_dims) + bool(heads)
    if sizes[0] > 1 and cfg.n_experts:
        n += sum(k for kind, k, _ in model.plan if kind == "moe")
    split = lambda k: tp > 1 and k % tp == 0
    if split(cfg.n_heads):
        n += gqa_layers_per_token(cfg, model) * (
            3 if split(cfg.n_kv_heads) else 1)
        if cfg.use_mla and cfg.family != "hybrid":
            n += cfg.n_layers * (1 if cfg.mla_absorbed else 2)
        if cfg.family == "ssm":
            n += model.n_super
    if cfg.family == "hybrid":
        d_inner, H = cfg.ssm_expand * cfg.d_model, model.n_ssm_heads
        n += cfg.n_layers * (split(2 * d_inner + 2 * cfg.ssm_state + H)
                             + split(d_inner + 2 * cfg.ssm_state))
    return n + split(head_width(cfg))


@pytest.mark.parametrize("case_mesh", SERVE_IDS)
def test_mesh_engine_holds_blocks_and_gathers_no_sequence_leaf(ranks,
                                                               case_mesh):
    """Every rank's cache leaves have the shape ``NamedSharding.block``
    gives, no rank holds a whole-sequence leaf, and one decode step's
    all-gathers are those of the design (:func:`expected_decode_gathers`):
    none of a sequence-sharded leaf."""
    case, mesh_name = case_mesh.split("-")
    want = expected_decode_gathers(case, mesh_name)
    for got in serving(ranks, case_mesh):
        assert got["blocks"] and not got["whole_sequence_leaf"], got
        assert got["decode_gathers"] == want, (got["decode_gathers"], want)


# ------------------------------------------------------------ TP and EP

LAYER_REL = 1e-6
LAYERS = {"gqa": ("prefill", "prefill_grads", "decode", "cache"),
          "mlp": ("swiglu", "swiglu_grads", "gelu", "gelu_grads"),
          "vocab": ("loss", "grads"),
          "moe": ("out", "grads"),
          "mla": ("prefill", "prefill_grads", "decode", "cache"),
          "mla_absorbed": ("prefill", "prefill_grads", "decode", "cache"),
          "cross": ("prefill", "prefill_grads", "decode", "cache"),
          "encoder": ("out", "grads"),
          "mamba": ("prefill", "prefill_grads", "long", "long_grads",
                    "kernel_prefill", "decode", "state"),
          "mlstm": ("prefill", "prefill_grads", "decode", "state"),
          "slstm": ("prefill", "prefill_grads", "decode", "state"),
          "seq_split": ("out", "grads"),
          "expert_width": ("out", "grads")}


@pytest.mark.parametrize("mesh_name", R.SERVE_MESHES)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_layer_twins_on_the_model_axis(ranks, layer, mesh_name):
    """Each layer with its weights split over 'model' (this rank's blocks,
    the shares combined over the group) against the whole layer on the
    same inputs, in f32: outputs, decode (and the cache blocks or states
    it writes) and gradients within 1e-6 relative (the ranks sum the
    partial products in another order). MLA, plain and absorbed, and the
    cross-attention, the seamless encoder, the Mamba-2 mixer (its
    full-sequence prefill through ``mamba2_scan`` on this rank's heads)
    and the xLSTM cells are held like GQA; the new twins' gradients each
    against its own norm, floored at a tenth of all the gradients' norm
    (``R.GRAD_FLOOR``: a gate bias's gradient is a sum that all but
    cancels). On 1 x 4 the 2 KV heads do not split and on 2 x 2 they do;
    the MoE's routing (and so its aux values) is the whole layer's
    exactly. ``seq_split``: a GQA layer of 6 heads, which 4 ranks do not
    divide, so its query's sequence splits over 'model'; ``expert_width``:
    a MoE layer of 6 experts, which 4 ranks do not divide, so each expert
    runs on this rank's block of its width."""
    for got in result(ranks, "layers"):
        twin = got[mesh_name][layer]
        for key in LAYERS[layer]:
            assert twin[key] <= LAYER_REL, (key, twin)
        if layer in ("gqa", "cross"):
            assert twin["kv_split"] == (mesh_name == "2x2")
        if layer == "mamba":
            assert twin["local_heads"] == 8 // MESH_SHAPES[mesh_name][0][1]
        if layer == "moe":
            assert twin["aux"] and twin["dropped"] > 0, twin
        if layer == "seq_split":
            # 6 heads: split on 2 ranks, the sequence split on 4
            assert twin["seq_split"] == (mesh_name == "1x4"), twin
        if layer == "expert_width":
            # 6 experts: 3 a rank on 2 ranks, on 4 every expert's width
            # block
            assert twin["expert_shape"] == ([6, 64, 16] if mesh_name == "1x4"
                                            else [3, 64, 64]), twin


COMPUTE_CASES = [f"{a}-{m}" for a in R.COMPUTE_ARCHS
                 for m in R.SERVE_MESHES]


@pytest.mark.parametrize("case", COMPUTE_CASES)
def test_no_model_split_leaf_is_whole_on_a_rank(ranks, case):
    """The shapes the sharded step and the serving engine compute on:
    every leaf the reference's rules split over 'model' is this rank's
    block (every layer runs split: GQA, MLA, cross-attention, the encoder,
    the MLPs, the vocabulary, the experts or, where 'model' does not
    divide them, their width, the Mamba mixer and the xLSTM cells), every
    other leaf whole; also a smoke llama with 6 heads and a smoke
    maverick with 6 experts."""
    for got in result(ranks, "compute_shapes"):
        for where in ("step", "engine"):
            leaves = got[case][where]
            assert any(x["split"] for x in leaves)
            for x in leaves:
                want = list(x["whole"])
                if x["split"]:
                    assert x["kept"], (where, x)
                    want[x["dim"]] //= x["tp"]
                assert x["shape"] == want, (where, x)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_step_compresses_model_blocks_as_whole_leaves(ranks,
                                                                 kind):
    """On two pods with a 'model' axis of two ranks: the compression of
    this rank's 'model' blocks (the whole leaves' int8 scale and top-k
    threshold, from the group) equals the whole leaves' compression cut
    to the blocks, bit for bit, with the whole leaves' wire bytes; the
    compressed step with nothing compressed equals its emulation on whole
    gradients over two steps within 1e-5 of the parameters' norm (the
    sharded step's bound: the ranks sum the partial products in another
    order); an int8 step keeps each error leaf in its gradient's 'model'
    block."""
    for got in result(ranks, "compressed_tp"):
        unit = got["unit"][kind]
        assert unit["grads"] and unit["err"] and unit["wire"], unit
        assert unit["split"] > 0 and got["keep_all"]
        assert max(got["none"]) < 1e-5, got["none"]
        assert all(got["int8_err_blocks"])


# ------------------------------------------------------------ FSDP gathers

def test_fsdp_step_gathers_one_block_at_a_time(ranks):
    """During a 2 x 2 FSDP step the gathered bytes alive at once stay at
    or below one step's block of the stacked leaves plus the largest
    unstacked leaf (each whole over 'data'), far below the rank's 'model'
    shard whole over 'data'; none is alive after the step."""
    for got in result(ranks, "fsdp_gathers"):
        high = got["gather"]["high_bytes"]
        assert 0 < high <= got["block"] + got["unstacked"], got
        assert high < got["shard"] and got["live_after"] == 0, got


def test_fsdp_step_gathers_equal_the_dry_run_count(ranks):
    """The step's DP gathers (the forward's, and the backward's re-gathers
    in place of the saved gathered tensors) and its reduce-scatters equal,
    in number and bytes, the all-gathers and reduce-scatters the dry-run's
    counter (``dryrun.count``) finds in the same step (the smoke llama's
    other collectives are all-reduces); the backward re-gathers and
    reduce-scatters every block the forward gathered for a leaf that
    requires grad."""
    for got in result(ranks, "fsdp_gathers"):
        g, c = got["gather"], got["dryrun"]
        assert g["gathers"] > 0 and g["regathers"] > 0, got
        assert c["all-gather"]["count"] == g["gathers"] + g["regathers"]
        assert c["all-gather"]["bytes"] == \
            g["gathered_bytes"] + g["regathered_bytes"]
        assert c["reduce-scatter"]["count"] == g["reduce_scatters"] > 0
        assert c["reduce-scatter"]["bytes"] == g["scattered_bytes"]


@pytest.mark.parametrize("path", ["train", "save", "decode"])
def test_no_dtensor_collective_on_the_mesh_paths(ranks, path):
    """With ``DTensor.full_tensor`` and ``DTensor.redistribute`` refused,
    a 2 x 2 FSDP training step still equals the one-device step (within
    the sharded step's bounds), its state saves and reads back whole bit
    for bit, and the mesh engine with FSDP-placed parameters prefills and
    decodes, picking the meshless engine's greedy tokens; nothing called
    either."""
    for got in result(ranks, "fsdp_gathers"):
        assert got["dtensor_calls"] == []
        if path == "train":
            assert got["train"]["loss_rel"] <= 1e-6, got["train"]
            assert got["train"]["params_rel"] < 1e-5, got["train"]
            assert got["held"] < 0.26
        elif path == "save":
            assert got["save"] == {"same": True, "steps": [1]}
        else:
            d = got["decode"]
            assert d["tokens_equal"] and d["gathers"] > 0 and d["split"] > 0
