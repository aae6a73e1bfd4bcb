"""The port's meshes on four ``gloo`` ranks on the CPU: sharded placement
against the reference's ``NamedSharding``, the sharded and compressed
training steps, restoring across meshes and the crash-restart loop.

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
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import pytest

import torch_mesh_ranks as R

WORLD = 4
JOIN_TIMEOUT_S = 120.0

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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, by rank."""
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
        JOIN_TIMEOUT_S - 30.0)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
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


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
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
