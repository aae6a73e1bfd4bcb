"""The port's cost-model link (``core/costmodel.py``, ``launch/dryrun.py``)
against the JAX package, on the CPU.

Tolerances: ``roofline_terms`` equal to the reference's on one record and
one spec (the same float arithmetic); ``arch_task_duration``'s f32
parameters equal; the meta-device FLOP counts equal their closed-form GEMM
counts exactly, and one ``mm``'s byte count its closed form; the
catalog-fed simulation's task times equal ``repro.core.des.simulate``'s bit
for bit (whole-second times).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import costmodel as ref_cost
from repro.core import des as ref_des
from repro.core import model as RM
from repro_torch import configs as CN
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import costmodel, experiment
from repro_torch.core import model as M
from repro_torch.launch import dryrun
from repro_torch.models.common import padded_vocab
from repro_torch.models.transformer import get_model

# the reference's spec of the H100's datasheet figures, for the twins
REF_H100 = ref_cost.HardwareSpec(*dataclasses.astuple(costmodel.H100))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record(kind="train", **kw):
    rec = {"arch": "x", "shape": "s", "kind": kind, "seq_len": 4096,
           "global_batch": 256, "n_devices": 1, "params": 1235814400,
           "active_params": 1235814400, "status": "ok",
           "flops_per_device": 1.15e16, "bytes_accessed_per_device": 3.3e14,
           "collectives": {}}
    rec.update(kw)
    return rec


RECORDS = [
    record(),
    record("prefill", seq_len=32768, global_batch=32),
    record("decode", seq_len=32768, global_batch=128,
           flops_per_device=8.7e11, bytes_accessed_per_device=7.8e11),
    # the reference's mesh cells: collectives and 256 devices
    record(n_devices=256, collectives={"all-reduce": {"bytes": 3e12,
                                                      "count": 4}}),
    record(flops_per_device=0.0, bytes_accessed_per_device=0.0),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["kind"])
@pytest.mark.parametrize("spec", ["v5e", "h100"])
def test_roofline_terms_equal_reference(rec, spec):
    hw, ref_hw = ((costmodel.V5E, ref_cost.V5E) if spec == "v5e"
                  else (costmodel.H100, REF_H100))
    assert dataclasses.astuple(hw) == dataclasses.astuple(ref_hw)
    audit = {"flops_per_device": 2e16, "bytes_per_device": 1e14,
             "collective_bytes_per_device": 5e11}
    for a in (None, audit):
        assert costmodel.roofline_terms(rec, hw, a) == \
            ref_cost.roofline_terms(rec, ref_hw, a)


def test_h100_is_the_default_and_v5e_is_kept():
    assert costmodel.H100.name == "h100_sxm5"
    assert (costmodel.H100.peak_flops, costmodel.H100.hbm_bw,
            costmodel.H100.ici_bw, costmodel.H100.hbm_bytes) == (
        989.4e12, 3.35e12, 900e9, 80e9)
    assert costmodel.roofline_terms(RECORDS[0]) == \
        costmodel.roofline_terms(RECORDS[0], costmodel.H100)
    assert dataclasses.astuple(costmodel.V5E) == \
        dataclasses.astuple(ref_cost.V5E)


def write_cell(root, subdir, mesh, rec):
    d = root / subdir / mesh
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{rec['arch']}__{rec['shape']}.json").write_text(json.dumps(rec))


@pytest.mark.parametrize("spec", ["v5e", "h100"])
@pytest.mark.parametrize("n_steps,sigma", [(1000, 0.25), (2000, 0.1)])
def test_arch_task_duration_equals_reference(tmp_path, monkeypatch, spec,
                                             n_steps, sigma):
    """The same cell JSON under both packages' directories: the lognormal
    parameters equal (f32), and neither reads the other's directory."""
    monkeypatch.setattr(ref_cost, "ARTIFACT_ROOT", str(tmp_path))
    hw, ref_hw = ((costmodel.V5E, ref_cost.V5E) if spec == "v5e"
                  else (costmodel.H100, REF_H100))
    rec = record(arch="llama3.2-1b", shape="train_4k")
    write_cell(tmp_path, "dryrun", "m", rec)
    write_cell(tmp_path, "dryrun_torch", "m", rec)
    want = ref_cost.arch_task_duration("llama3.2-1b", "train_4k", "m",
                                       n_steps, sigma, ref_hw)
    got = costmodel.arch_task_duration("llama3.2-1b", "train_4k", "m",
                                       n_steps, sigma, hw, root=tmp_path)
    for f in ("family", "p0", "p1", "p2"):
        assert np.asarray(getattr(got, f)).tobytes() == \
            np.asarray(getattr(want, f)).tobytes(), f
    assert costmodel.load_audit("m", "llama3.2-1b", "train_4k",
                                root=tmp_path) is None
    (tmp_path / "dryrun_torch" / "m" / "llama3.2-1b__train_4k.json").unlink()
    assert costmodel.arch_task_duration("llama3.2-1b", mesh="m",
                                        root=tmp_path) is None
    write_cell(tmp_path, "dryrun_torch", "m",
               dict(rec, status="skip"))
    assert costmodel.arch_task_duration("llama3.2-1b", mesh="m",
                                        root=tmp_path) is None


# ------------------------------------------------------------ the counts

def closed_form(cfg, B, S):
    """The forward's GEMM FLOPs: ``(blocks, MLP down-projections, head)``.
    Per layer the q/k/v/o projections, the scores and the probabilities
    times v (full S x S products: the plain path masks, it does not skip),
    and the MLP; then the LM head over the padded vocab."""
    D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    T = B * S
    proj = 2 * T * D * (2 * H * hd + 2 * Hkv * hd)
    att = 2 * 2 * B * H * S * S * hd
    n_mats = 2 if cfg.mlp_type == "gelu" else 3
    mlp = 2 * T * D * F * n_mats
    down = 2 * T * F * D
    vocab = (cfg.vocab_size if cfg.tie_embeddings
             else padded_vocab(cfg.vocab_size))
    return cfg.n_layers * (proj + att + mlp), cfg.n_layers * down, \
        2 * T * D * vocab


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
def test_meta_flop_count_equals_closed_form(arch):
    """Forward == the closed form; a train step with ``remat="none"``
    (the smoke configs') == 3 forwards (each GEMM's backward is two GEMMs
    of its size); under ``remat="block"`` the backward reruns each block's
    forward up to the last tensor it keeps, so the block's forward less
    its MLP down-projection is added."""
    B, S = 4, 32
    spec = ShapeSpec("t", "train", S, B)
    for remat in ("none", "block"):
        cfg = CN.get_smoke_config(arch, remat=remat)
        blocks, down, head = closed_form(cfg, B, S)
        params, _ = CN.param_specs(cfg)
        batch = CN.input_specs(cfg, spec)["batch"]
        with torch.no_grad():
            fwd = dryrun.count(
                lambda: get_model(cfg).loss_fn(params, batch))["flops"]
        assert fwd == blocks + head
        step, _ = dryrun.cell_step(cfg, spec)
        train = dryrun.count(step)["flops"]
        recompute = 0 if remat == "none" else blocks - down
        assert train == 3 * fwd + recompute, remat
        step, _ = dryrun.cell_step(cfg, spec, microbatches=2)
        assert dryrun.count(step)["flops"] == train


def test_meta_byte_count_of_one_mm():
    a = torch.empty((64, 48), dtype=torch.bfloat16, device="meta")
    b = torch.empty((48, 80), dtype=torch.bfloat16, device="meta")
    c = dryrun.count(lambda: a @ b)
    assert c["bytes"] == (64 * 48 + 48 * 80 + 64 * 80) * 2
    assert c["flops"] == 2 * 64 * 48 * 80
    assert c["output_bytes"] == 64 * 80 * 2
    # views move nothing; a reshape that must copy moves both copies
    assert dryrun.count(lambda: a.t()[None, 2:])["bytes"] == 0
    assert dryrun.count(lambda: a.t().reshape(-1))["bytes"] == 2 * 64 * 48 * 2


def test_full_width_cell_is_written_and_priced(tmp_path):
    """llama3.2-1b x train_4k at full width: the reference's record keys,
    one device, no collectives, the argument bytes of bf16 parameters, f32
    moments and the batch, and a price on the H100 spec."""
    recs = dryrun.write_cells(["llama3.2-1b"], ["train_4k"], root=tmp_path,
                              log=lambda *a: None)
    rec = recs[("llama3.2-1b", "train_4k")]
    path = tmp_path / "dryrun_torch" / "h100x1" / "llama3.2-1b__train_4k.json"
    assert json.loads(path.read_text()) == rec
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["collectives"] == {} and rec["microbatches"] == 2
    assert rec["fsdp"] is False
    for k in ("kind", "seq_len", "global_batch", "params", "active_params",
              "flops_per_device", "bytes_accessed_per_device", "memory",
              "lower_s", "compile_s", "cost_raw", "overrides"):
        assert k in rec, k
    n = rec["params"]
    assert n == CN.get_config("llama3.2-1b").param_count()
    assert rec["memory"]["argument_size_in_bytes"] == \
        n * (2 + 4 + 4) + 4 + 2 * 256 * 4096 * 4
    blocks, down, head = closed_form(CN.get_config("llama3.2-1b"), 256, 4096)
    assert rec["flops_per_device"] == 3 * (blocks + head) + blocks - down
    terms = costmodel.roofline_terms(rec)
    assert terms == ref_cost.roofline_terms(rec, REF_H100)
    assert terms["step_s"] > 0
    dist = costmodel.arch_task_duration("llama3.2-1b", root=tmp_path)
    assert float(dist.p0) == pytest.approx(np.log(1000 * terms["step_s"]),
                                           rel=1e-6)
    # cached: not counted again
    assert dryrun.write_cells(["llama3.2-1b"], ["train_4k"], root=tmp_path,
                              log=lambda *a: None) == {}


def test_cli_writes_skip_and_tagged_cells(tmp_path):
    dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                 "--root", str(tmp_path)])
    d = tmp_path / "dryrun_torch" / "h100x1"
    rec = json.loads((d / "granite-3-8b__long_500k.json").read_text())
    assert rec["status"] == "skip" and "SKIP" in rec["skip_reason"]
    dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k",
                 "--set", "n_layers=2", "--tag", "two", "--root",
                 str(tmp_path)])
    rec = json.loads((d / "stablelm-3b__decode_32k__two.json").read_text())
    assert rec["status"] == "ok" and rec["overrides"] == {"n_layers": "2"}
    assert costmodel.load_cell("h100x1", "stablelm-3b", "decode_32k", "two",
                               root=tmp_path) == rec
    with pytest.raises(NotImplementedError):
        dryrun.lower_cell("granite-20b", "train_4k", {"fsdp": True})


# ------------------------------------------------------------ the catalog

SMOKE_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "head_dim", "ssm_state", "ssm_head_dim",
                "attn_every")


@pytest.fixture(scope="module")
def catalog_root(tmp_path_factory):
    """train_4k cells of the five ported archs at their smoke widths (the
    shape's full 256 x 4,096 tokens, counted on the meta device; zamba2
    keeps its full SSD chunk, 128)."""
    root = tmp_path_factory.mktemp("cells")
    for arch in CN.ARCHS:
        smoke = CN.get_smoke_config(arch)
        over = {f: getattr(smoke, f) for f in SMOKE_FIELDS}
        dryrun.write_cells([arch], ["train_4k"], root=root, overrides=over,
                           log=lambda *a: None)
    return root


def test_catalog_holds_every_ported_arch(catalog_root):
    cat = costmodel.accelerator_workload_catalog(root=catalog_root)
    assert sorted(cat) == sorted(CN.ARCHS)
    for arch, d in cat.items():
        assert int(d.family) == 0 and float(d.p1) == np.float32(0.25)
        rec = costmodel.load_cell("h100x1", arch, "train_4k",
                                  root=catalog_root)
        step = costmodel.roofline_terms(rec)["step_s"]
        assert float(d.p0) == np.float32(np.log(max(step * 1000, 1e-3)))
    assert costmodel.accelerator_workload_catalog(
        mesh="other", root=catalog_root) == {}


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_pods", [2, 4, 8])
def test_catalog_fed_experiment_equals_numpy_engine(catalog_root, chip_smoke,
                                                    n_pods):
    """``chip_smoke.py`` 17(b)'s workload (``examples/accelerator_platform.
    py``'s retraining tasks drawn from the catalog, every time rounded up
    to a whole second) pinned to an ``ExperimentSpec`` on the ``"torch"``
    engine (CPU) against ``des.simulate`` of the same workload: every
    task's start and finish equal bit for bit."""
    cat = costmodel.accelerator_workload_catalog(
        n_steps=chip_smoke.CATALOG_STEPS, root=catalog_root)
    cols = chip_smoke.catalog_workload(cat)
    assert np.array_equal(cols["exec_time"], np.ceil(cols["exec_time"]))
    plat = M.PlatformConfig(resources=(M.ResourceConfig("compute", 1),
                                       M.ResourceConfig("pods", n_pods)))
    spec = experiment.ExperimentSpec("catalog", platform=plat,
                                     horizon_s=7 * 86400.0,
                                     workload=M.Workload(**cols))
    got = experiment.run_experiment(spec, device="cpu").records
    rplat = RM.PlatformConfig(resources=(RM.ResourceConfig("compute", 1),
                                         RM.ResourceConfig("pods", n_pods)))
    tr = ref_des.simulate(RM.Workload(**cols), rplat)
    order = np.argsort(got.pipeline, kind="stable")
    np.testing.assert_array_equal(got.start[order], tr.start[:, 0])
    np.testing.assert_array_equal(got.finish[order], tr.finish[:, 0])
    wait = got.start - got.ready
    assert (wait >= 0).all() and np.isfinite(got.finish).all()
    assert got.start.size == chip_smoke.CATALOG_JOBS
