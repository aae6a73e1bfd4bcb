"""The port stands alone: no JAX, no reference module, no silent CPU.

An AST walk finds no ``jax`` and no ``repro`` import in ``src/repro_torch``
(its ``reliability/``, ``obs/``, ``checkpoint/``, ``optim/``, ``data/``,
``train/`` and ``analysis/`` subpackages included), ``chip_smoke.py`` or
``tools/``; the auditor (``analysis/``) has a counterpart of every file of
the reference's; a fresh interpreter runs the port (the wave loop, the
serving paths, the hybrid's forward, the fit -> synthesize -> simulate
path, the full-stack experiment on the batched and the heap engine, the
compaction and streaming drivers, a
crash-restart training run, the cost-model path: the one-card cell writer,
the catalog, the profiler and a gelu-MLP model, and the parity auditor)
without loading ``jax``; with no card the entry points raise
unless the caller asks for the CPU; the admission rankings and the model
families that are not ported are refused.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import experiment, fitting, vdes, workload
from repro_torch.launch import simulate
from repro_torch.launch.serve import run_serving
from repro_torch.models.transformer import DecoderLM, get_model
from repro_torch.serving.engine import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "artifacts" / "pipesim_params.npz"
EXAMPLE_FILES = sorted((ROOT / "examples" / "torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) \
    + EXAMPLE_FILES


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists()
    for name in _imports(path):
        top = name.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path}: imports {name}"
        assert top != "repro", f"{path}: imports {name}"
        assert top != "benchmarks", f"{path}: imports {name}"


def test_walk_covers_every_subpackage():
    packages = {p.parent.name for p in PORT_FILES}
    assert {"reliability", "obs", "checkpoint", "core", "ops",
            "kernels", "optim", "data", "train", "configs", "launch",
            "serving", "analysis", "parallel"} <= packages
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/costmodel.py",
            "src/repro_torch/obs/profile.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/configs/granite_3_8b.py",
            "src/repro_torch/configs/granite_20b.py",
            "src/repro_torch/configs/stablelm_3b.py",
            "src/repro_torch/configs/deepseek_v3_671b.py",
            "src/repro_torch/configs/llama4_maverick.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/xlstm.py",
            "src/repro_torch/configs/xlstm_125m.py",
            "src/repro_torch/parallel/compression.py"} <= names
    # the examples: a port form of every reference example
    ref = {p.name for p in (ROOT / "examples").glob("*.py")}
    assert {f"examples/torch/{n}" for n in ref} <= names
    # the parity auditor: a counterpart of every reference file
    ref = {p.name for p in (ROOT / "src" / "repro" / "analysis").glob("*.py")}
    assert {f"src/repro_torch/analysis/{n}" for n in ref} <= names


# a one-replica full-stack experiment on the CPU: a controller, a fleet
# whose retrain durations come from the committed fit, a probe and a
# reliability timeline with spot evictions
FULL_STACK = (
    "from repro_torch.core import experiment, fitting, workload\n"
    "from repro_torch.core.runtime import FleetSpec, TriggerSpec\n"
    "from repro_torch.obs.probes import ProbeSpec\n"
    "from repro_torch.ops.capacity import ReactiveController\n"
    "from repro_torch.reliability import ReliabilitySpec, SpotPoolSpec\n"
    "H = 0.1 * 86400.0\n"
    "spec = experiment.ExperimentSpec('fs', horizon_s=H, n_replicas=2,\n"
    "    workload=workload.generate_empirical_workload(0, H),\n"
    "    fleet=FleetSpec(n_models=3, drift_scale=300.0),\n"
    "    trigger=TriggerSpec(interval_s=900.0, cooldown_s=1800.0,\n"
    "                        drift_threshold=0.02),\n"
    "    probe=ProbeSpec(interval_s=900.0),\n"
    "    reliability=ReliabilitySpec(spot=SpotPoolSpec(frac=0.2,\n"
    "        evict_mtbe_s=H / 3), time_quantum_s=1.0),\n"
    ").with_(controller=ReactiveController(interval_s=900.0))\n")


NO_REFERENCE = (
    "assert 'jax' not in sys.modules, 'jax was imported'\n"
    "assert not any(m == 'repro' or m.startswith('repro.')\n"
    "               for m in sys.modules), 'repro was imported'\n"
    "print('ok')\n")


def run_fresh(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_package_surface_leaves_jax_unloaded():
    """``repro_torch.core`` and ``repro_torch.ops`` export the reference's
    front door without loading JAX, whichever is imported first."""
    for first, second in (("core", "ops"), ("ops", "core")):
        run_fresh(
            "import sys\n"
            f"import repro_torch.{first}, repro_torch.{second}\n"
            "from repro_torch.core import ExperimentSpec, Sweep, Engine\n"
            "from repro_torch.ops import Scenario, SLOConfig\n"
            + NO_REFERENCE)


def test_cpu_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.core import batching, vdes, workload\n"
        "from repro_torch.core import model as M\n"
        "wl = workload.generate_empirical_workload(0, 1800.0)\n"
        "cols = batching.pad_workloads([wl, wl], M.PlatformConfig())\n"
        "out = vdes.simulate_ensemble(**batching.to_tensors(cols, 'cpu'),\n"
        "    capacities=np.array([[4, 2], [8, 4]]), device='cpu')\n"
        "assert bool(out['done'].all()), out['done']\n" + NO_REFERENCE)


def test_cpu_serving_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "from repro_torch.launch.serve import run_serving\n"
        "r = run_serving('llama3.2-1b', batch=2, prompt_len=8, new_tokens=3,\n"
        "                smoke=True, device='cpu')\n"
        "assert r['all_in_vocab'] and r['logits_finite'], r\n"
        "assert r['generated_shape'] == [2, 3], r\n" + NO_REFERENCE)


def test_cpu_hybrid_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "import torch\n"
        "from repro_torch import configs, kernels\n"
        "from repro_torch.launch.serve import run_serving\n"
        "from repro_torch.models.transformer import get_model\n"
        "cfg = configs.get_smoke_config('zamba2-1.2b',\n"
        "                               ssm_impl='mamba_kernel')\n"
        "m = get_model(cfg)\n"
        "toks = torch.randint(0, cfg.vocab_size, (2, 16))\n"
        "loss, _ = m.loss_fn(m.init(0, 'cpu'), {'tokens': toks,\n"
        "                                       'labels': toks})\n"
        "assert bool(torch.isfinite(loss)), loss\n"
        "r = run_serving('zamba2-1.2b', batch=2, prompt_len=8, new_tokens=3,\n"
        "                smoke=True, device='cpu')\n"
        "assert r['all_in_vocab'] and r['logits_finite'], r\n" + NO_REFERENCE)


def test_cpu_xlstm_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "import tempfile\n"
        "import torch\n"
        "from repro_torch.launch.serve import run_serving\n"
        "from repro_torch.launch.train import run_training\n"
        "from repro_torch.parallel import compression as C\n"
        "r = run_serving('xlstm-125m', batch=2, prompt_len=8, new_tokens=3,\n"
        "                smoke=True, device='cpu')\n"
        "assert r['all_in_vocab'] and r['logits_finite'], r\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    t = run_training('xlstm-125m', steps=2, batch=2, seq=8,\n"
        "                     log_every=1, ckpt_dir=d, device='cpu')\n"
        "assert len(t['history']) == 2, t['history']\n"
        "cfg = C.CompressionConfig(kind='int8')\n"
        "g = {'w': torch.randn(8, 8)}\n"
        "out = C.compressed_psum_pod(cfg, g, C.init_error_state(cfg, g))\n"
        "assert out[2] == 68, out[2]\n" + NO_REFERENCE)


def test_cpu_moe_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "from repro_torch.launch.serve import run_serving\n"
        "for arch, impl in (('deepseek-v3-671b', 'xla'),\n"
        "                   ('llama4-maverick-400b-a17b', 'flash')):\n"
        "    r = run_serving(arch, batch=2, prompt_len=8, new_tokens=3,\n"
        "                    smoke=True, attn_impl=impl, device='cpu')\n"
        "    assert r['all_in_vocab'] and r['logits_finite'], r\n"
        + NO_REFERENCE)


def test_cpu_fit_path_leaves_jax_unloaded():
    run_fresh(
        "import sys\n"
        "from repro_torch.core import experiment, fitting, workload\n"
        "wl = workload.generate_empirical_workload(1, 0.3 * 86400.0)\n"
        "p = fitting.fit_simulation_params(wl, asset_components=4,\n"
        "    em_iters=3, interarrival_families=(0,), device='cpu')\n"
        "res = experiment.run_experiment(experiment.ExperimentSpec(\n"
        "    'x', horizon_s=1800.0, n_replicas=2), p, device='cpu')\n"
        "assert res.summary['n_replicas'] == 2, res.summary\n"
        + NO_REFERENCE)


def test_cpu_full_stack_run_leaves_jax_unloaded():
    run_fresh(
        "import sys\n" + FULL_STACK +
        f"p = fitting.SimulationParams.load({str(ARTIFACT)!r}, 'cpu')\n"
        "res = experiment.run_experiment(spec, p, device='cpu')\n"
        "r = res.replica_summaries[0]\n"
        "assert 'lifecycle' in r and 'availability' in r, sorted(r)\n"
        "assert 'planned_total_cost' in r, sorted(r)\n" + NO_REFERENCE)


def test_cpu_heap_engine_run_leaves_jax_unloaded():
    """The full-stack experiment on the ``"numpy"`` heap engine and
    ``profile_numpy``, in a fresh interpreter."""
    run_fresh(
        "import sys\n" + FULL_STACK +
        "from repro_torch.core import model as M\n"
        "from repro_torch.obs import profile\n"
        f"p = fitting.SimulationParams.load({str(ARTIFACT)!r}, 'cpu')\n"
        "import dataclasses\n"
        "spec = dataclasses.replace(spec, engine='numpy')\n"
        "res = experiment.run_experiment(spec, p, device='cpu')\n"
        "r = res.replica_summaries[0]\n"
        "assert 'lifecycle' in r and 'availability' in r, sorted(r)\n"
        "pr = profile.profile_numpy(spec.workload, M.PlatformConfig(),\n"
        "                           repeats=1)\n"
        "assert pr['waves'] > 0, pr\n" + NO_REFERENCE)


def test_cpu_compaction_and_stream_leave_jax_unloaded():
    run_fresh(
        "import sys, tempfile, os\n"
        "import numpy as np\n"
        "from repro_torch.core import batching, compaction, fitting, workload\n"
        "from repro_torch.core import model as M\n"
        "from repro_torch.obs import spans\n"
        "from repro_torch import stream\n"
        "wl = workload.generate_empirical_workload(0, 1800.0)\n"
        "cols = batching.pad_workloads([wl, wl], M.PlatformConfig())\n"
        "cols.pop('n_max')\n"
        "out = compaction.simulate_ensemble_compacted(**cols,\n"
        "    capacities=np.array([[4, 2], [8, 4]]), device='cpu')\n"
        "assert bool(out['done'].all()), out['done']\n"
        f"p = fitting.SimulationParams.load({str(ARTIFACT)!r}, 'cpu')\n"
        "src = stream.SyntheticSource(p, block_size=64, until_s=3600.0,\n"
        "                             device='cpu')\n"
        "sr = stream.stream_simulate(src, horizon_s=3600.0, device='cpu')\n"
        "assert sr.n_windows >= 8 and sr.records.start.size, sr.summary\n"
        "f = os.path.join(tempfile.mkdtemp(), 's.jsonl')\n"
        "spans.write_spans_jsonl(spans.build_spans(sr.records), f)\n"
        "assert stream.SpanSource(f).workload.n == sr.n_pipelines\n"
        + NO_REFERENCE)


def test_cpu_training_run_leaves_jax_unloaded():
    run_fresh(
        "import sys, tempfile\n"
        "from repro_torch.launch.train import run_training\n"
        "out = run_training('zamba2-1.2b', steps=3, batch=2, seq=16,\n"
        "                   ckpt_every=2, fault_at=[2], device='cpu',\n"
        "                   ckpt_dir=tempfile.mkdtemp())\n"
        "assert out['restarts'] == 1 and out['final_step'] == 3, out\n"
        + NO_REFERENCE)


def test_cpu_costmodel_path_leaves_jax_unloaded():
    """The one-card cell writer (meta device), the catalog priced on the
    H100 spec, the catalog-fed simulation, the profiler and the smoke
    granite-20b's serving on the CPU, in a fresh interpreter."""
    run_fresh(
        "import sys, tempfile\n"
        "import numpy as np, torch\n"
        "from repro_torch.core import costmodel, experiment, workload\n"
        "from repro_torch.core import model as M\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.serve import run_serving\n"
        "from repro_torch.obs import profile\n"
        "root = tempfile.mkdtemp()\n"
        "dryrun.main(['--arch', 'llama3.2-1b', '--shape', 'train_4k',\n"
        "             '--root', root])\n"
        "cat = costmodel.accelerator_workload_catalog(root=root)\n"
        "assert list(cat) == ['llama3.2-1b'], cat\n"
        "wl = workload.generate_empirical_workload(0, 1800.0)\n"
        "p = profile.profile_compile_execute(wl, M.PlatformConfig(),\n"
        "                                    repeats=1, device='cpu')\n"
        "assert p['waves'] > 0, p\n"
        "r = run_serving('granite-20b', batch=2, prompt_len=8, new_tokens=3,\n"
        "                smoke=True, device='cpu')\n"
        "assert r['all_in_vocab'] and r['logits_finite'], r\n"
        + NO_REFERENCE)


def test_cpu_analysis_run_leaves_jax_unloaded():
    """The auditor's CLI on the CPU (the AST pass reads the reference's
    sources as text, the trace pass runs the port's engine) in a fresh
    interpreter."""
    run_fresh(
        "import sys, tempfile, os\n"
        "from repro_torch.analysis.__main__ import main\n"
        "out = os.path.join(tempfile.mkdtemp(), 'a.json')\n"
        f"rc = main(['--root', {str(ROOT)!r}, '--device', 'cpu',\n"
        "           '--passes', 'ast,jaxpr', '--json', out])\n"
        "assert rc == 0, rc\n" + NO_REFERENCE)


def test_analysis_without_card_raises_unless_cpu_is_asked_for(monkeypatch,
                                                              tmp_path):
    """The passes that run the engine run on the card or raise; the CLI
    reports that as an analyzer error (exit 2); with the CPU asked for
    they run. The AST pass runs no code and needs no device."""
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.harness import smoke_spec
    from repro_torch.analysis.jaxpr_audit import run_jaxpr_audit
    from repro_torch.analysis.recompile_audit import run_recompile_audit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_jaxpr_audit(str(ROOT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_recompile_audit(str(ROOT))
    out = str(tmp_path / "a.json")
    assert main(["--root", str(ROOT), "--passes", "jaxpr",
                 "--json", out]) == 2
    assert main(["--root", str(ROOT), "--passes", "ast", "--json", out]) == 0
    grid = experiment.Sweep(smoke_spec(), {"capacity:a": [3, 4]})
    assert run_recompile_audit(str(ROOT), sweep=grid, device="cpu") == []


def test_profiler_without_card_raises_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.core import model as M
    from repro_torch.obs import profile
    from repro_torch.serving.engine import make_prefill_step, make_serve_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = workload.generate_empirical_workload(0, 1800.0)
    for fn in (profile.profile_compile_execute, profile.stage_attribution):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(wl, M.PlatformConfig(), repeats=1)
    cfg = configs.get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prefill_step(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_step(cfg, 1, 8)
    out = profile.stage_attribution(wl, M.PlatformConfig(), repeats=1,
                                    device="cpu")
    assert list(out) == ["select+completion+admission"]


def test_training_and_feedback_without_card_raise_unless_cpu_is_asked_for(
        monkeypatch, tmp_path):
    from repro_torch.core.runtime import TriggerSpec, run_feedback_simulation
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch.train import run_training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(steps=1, batch=2, seq=8, ckpt_every=0, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training("llama3.2-1b", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_batch(DataConfig(64, 2, 8), 0)
    wl = workload.generate_empirical_workload(0, 1800.0)
    fb = dict(n_models=2, workload=wl,
              trigger=TriggerSpec(interval_s=600.0,
                                  retrain_durations=(60.0, 60.0, 60.0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_feedback_simulation(None, 0, 1800.0, **fb)
    assert run_training("llama3.2-1b", device="cpu", **kw)["final_step"] == 1
    assert synth_batch(DataConfig(64, 2, 8), 0, "cpu")["tokens"].shape == \
        (2, 8)
    assert run_feedback_simulation(None, 0, 1800.0, device="cpu",
                                   **fb).records.start.size


def test_full_stack_without_card_raises_unless_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ns = {}
    exec(FULL_STACK, ns)
    spec = ns["spec"]
    params = fitting.SimulationParams.load(str(ARTIFACT), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.run_experiment(spec, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.Sweep(spec, {"trigger:drift_threshold": [0.02]}).run(
            params)
    res = experiment.run_experiment(spec, params, device="cpu")
    assert res.summary["n_replicas"] == 2


def test_fit_path_without_card_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = workload.generate_empirical_workload(0, 1800.0)
    spec = experiment.ExperimentSpec("x", horizon_s=1800.0, workload=wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fitting.fit_simulation_params(wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fitting.SimulationParams.load(str(ARTIFACT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.run_experiment(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiment.Sweep(spec, {"policy": [0, 2]}).run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate.main(["--params-cache", str(ARTIFACT)])
    assert experiment.run_experiment(spec, device="cpu").summary[
        "n_pipelines"] == wl.n


def test_no_card_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = workload.generate_empirical_workload(0, 1800.0)
    args = (wl.arrival[None], wl.n_tasks[None], wl.task_res[None],
            wl.exec_time[None], wl.priority[None], np.array([[4, 2]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vdes.simulate_ensemble(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vdes.simulate_to_trace(wl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vdes.VWorkload.from_workload(wl)
    assert vdes.simulate_ensemble(*args, device="cpu")["done"].all()


def test_drivers_without_card_raise_unless_cpu_is_asked_for(monkeypatch):
    """The compaction and streaming drivers, the stream's synthetic source
    and the ``"torch-compact"``/``"torch-stream"`` engines run on the card
    or raise; none carries on on the CPU unasked."""
    from repro_torch import stream
    from repro_torch.core import compaction, engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = workload.generate_empirical_workload(0, 1800.0)
    args = (wl.arrival[None], wl.n_tasks[None], wl.task_res[None],
            wl.exec_time[None], wl.priority[None], np.array([[4, 2]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compaction.simulate_ensemble_compacted(*args)
    params = fitting.SimulationParams.load(str(ARTIFACT), device="cpu")
    src = stream.SyntheticSource(params, n_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream.stream_simulate(src, horizon_s=1800.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream.oneshot_reference(src, horizon_s=1800.0)
    spec = experiment.ExperimentSpec("x", horizon_s=1800.0, workload=wl)
    for name in ("torch-compact", "torch-stream"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engines.get_engine(name).run(spec.with_(engine=name), params)
    assert compaction.simulate_ensemble_compacted(
        *args, device="cpu")["done"].all()


def test_serving_without_card_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("llama3.2-1b")
    kw = dict(batch=1, prompt_len=4, new_tokens=2, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serving("llama3.2-1b", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, ServeConfig(batch=1, max_len=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(cfg).init(0)
    assert run_serving("llama3.2-1b", device="cpu", **kw)["all_in_vocab"]


@pytest.mark.parametrize("overrides,error", [
    # a vlm config needs cross_every > 1, where the reference asserts
    (dict(family="vlm", cross_every=1), ValueError),
    # a hybrid without its SSM fields is malformed, not unported
    (dict(family="hybrid"), ValueError),
    # MLA in the hybrid's shared block under flash: the kernel takes one
    # head dim for q, k and v, MLA's v is narrower
    (dict(family="hybrid", attn_every=2, ssm_state=16, use_mla=True,
          attn_impl="flash"), ValueError),
    # a family neither package has
    (dict(family="rnn"), ValueError),
    # an encoder-decoder needs both stacks, where the reference asserts
    (dict(family="audio", n_enc_layers=0, n_dec_layers=2), ValueError),
    # MLA in a moe_super plan: the reference builds a latent cache its
    # super block cannot index
    (dict(family="moe", n_experts=4, use_mla=True, moe_interleave=2),
     ValueError)])
def test_unported_models_are_refused(overrides, error):
    with pytest.raises(error):
        get_model(configs.get_smoke_config("llama3.2-1b", **overrides))


def test_unported_archs_are_refused():
    """Every arch of the reference's registry is ported (the port's order
    differs: llama first); an unknown one is refused."""
    from repro import configs as ref_configs
    assert configs.ARCHS == ["llama3.2-1b", "zamba2-1.2b", "granite-3-8b",
                             "granite-20b", "stablelm-3b",
                             "deepseek-v3-671b", "llama4-maverick-400b-a17b",
                             "llama-3.2-vision-90b", "seamless-m4t-large-v2",
                             "xlstm-125m"]
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    with pytest.raises(ValueError, match="unported"):
        configs.get_config("gpt-5")


def test_unported_arguments_are_refused():
    """Every admission ranking of the reference is ported but its Pallas
    route (the port's is ``"kernel"``); the segment-restart hooks are
    (``tests/test_torch_segments.py``), and a ``resume`` that lacks a
    state key is refused."""
    wl = workload.generate_empirical_workload(0, 1800.0)
    args = (wl.arrival[None], wl.n_tasks[None], wl.task_res[None],
            wl.exec_time[None], wl.priority[None], np.array([[4, 2]]))
    assert vdes.ADMISSION_SORTS == ("kernel", "dense", "fused", "chained")
    for sort in ("pallas", "sorted"):
        with pytest.raises(ValueError):
            vdes.simulate_ensemble(*args, device="cpu", admission_sort=sort)
    with pytest.raises(KeyError):
        vdes.simulate_ensemble(*args, device="cpu", resume={})
    out = vdes.simulate_ensemble(*args, device="cpu", resume=None,
                                 wave_budget=None, time_budget=None,
                                 return_state=False)
    assert "state" not in out and bool(out["done"].all())


def _load_example(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", [p for p in EXAMPLE_FILES
                                  if not p.name.startswith("_")],
                         ids=lambda p: p.stem)
def test_example_without_card_raises_unless_cpu_is_asked_for(monkeypatch,
                                                             path):
    """An example's ``main()`` with no ``device`` runs on the card or
    raises before any work; the CPU runs only when asked for
    (``tests/test_torch_examples.py`` runs each with ``device="cpu"``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load_example(path).main()


def test_example_command_line_without_card_fails_unless_cpu_is_asked_for(
        tmp_path):
    """From the command line: no card and no ``--device cpu`` is a failure
    naming the flag; ``--device cpu`` runs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, str(ROOT / "examples" / "torch" / "train_lm.py"),
           "--steps", "4", "--ckpt-dir", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"restarts": 1' in proc.stdout
