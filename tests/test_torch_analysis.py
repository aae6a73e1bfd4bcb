"""The port's parity auditor (src/repro_torch/analysis) against the
reference's (src/repro/analysis).

AST twins: each fixture tree is laid out under both ``src/repro/`` and
``src/repro_torch/`` in one root, and both auditors must give the same
rule set (the reference's AST, pragma, baseline and CLI cases that pass on
this tree). Where the port's rule differs by design — ``engine-fma`` flags
fused multiply-add *operations*, not a bare ``a - b*c``, and ``hot-f64``
flags f64 dtypes, not ``float()`` — each side has its own must-trigger and
must-not-trigger cases. Trace rules run on small synthetic torch functions
(a must-trigger and a must-not-trigger case each) and on the real wave of
the smoke spec, which audits clean; mutated scratch copies of the port's
``vdes.py`` are caught by the CLI and by the trace pass.
"""
import json
import os
import shutil
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import findings as RF
from repro.analysis.ast_audit import audit_tree as ref_audit_tree
from repro_torch.analysis import findings as F
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.ast_audit import audit_tree
from repro_torch.analysis.harness import capture_calls, smoke_spec
from repro_torch.analysis.jaxpr_audit import (audit_call, audit_step,
                                              finding_keys, run_jaxpr_audit)
from repro_torch.core import vdes
from repro_torch.core.experiment import run_experiment
from repro_torch.core.numerics import fma_free_madd, guarded_denominator

REPO_ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- helpers

def write_tree(root, files):
    for rel, src in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(textwrap.dedent(src))


def rules_of(findings):
    return sorted({f.rule for f in findings})


def port_variant(rel, src):
    """A reference fixture file as the port would write it: torch for
    jax.numpy, and the wave loop's function name."""
    src = src.replace("import jax.numpy as jnp", "import torch")
    src = src.replace("jnp.", "torch.")
    if rel == "core/vdes.py":
        src = src.replace("def simulate(", "def simulate_ensemble(")
    return src


def twin(tmp_path, files):
    """``(reference rules, port rules)`` of one fixture tree laid out under
    both packages in one root (``files`` keyed by package-relative
    path)."""
    tree = {}
    for rel, src in files.items():
        tree[f"src/repro/{rel}"] = src
        tree[f"src/repro_torch/{rel}"] = port_variant(rel, src)
    write_tree(str(tmp_path), tree)
    return (rules_of(ref_audit_tree(str(tmp_path))),
            rules_of(audit_tree(str(tmp_path))))


def port_findings(tmp_path, files):
    write_tree(str(tmp_path), files)
    return audit_tree(str(tmp_path))


VDES_OK = """
    def simulate(x):
        def _select_events(s):
            return s

        def _fleet_stage(s):
            return s
        return _fleet_stage(_select_events(x))
"""

DES_OK = """
    # mirror: vdes._select_events
    A = 1
    # mirror: vdes._fleet_stage
    B = 2
"""


# ------------------------------------------------------------- AST: mirror

@pytest.mark.parametrize("des,want", [
    (DES_OK, []),
    ("# mirror: vdes._select_events\n", ["mirror-missing"]),
    (DES_OK + "    # mirror: vdes._gone_stage\n", ["mirror-stale"]),
], ids=["clean", "missing", "stale"])
def test_mirror_twin(tmp_path, des, want):
    ref, port = twin(tmp_path, {"core/vdes.py": VDES_OK, "core/des.py": des})
    assert ref == port == want


def test_mirror_port_stage_set_must_equal_the_references(tmp_path):
    """The port's stages are also held against the reference's
    ``vdes.simulate`` (read as text): a stage the port lacks and a stage
    the reference lacks are both caught, even where the markers agree."""
    port_vdes = VDES_OK.replace("def simulate(", "def wave_program(")
    fs = port_findings(tmp_path, {
        "src/repro/core/vdes.py": VDES_OK.replace("_fleet_stage",
                                                  "_probe_stage"),
        "src/repro_torch/core/des.py": DES_OK,
        "src/repro_torch/core/vdes.py": port_vdes})
    got = {(f.rule, f.file) for f in fs}
    assert got == {("mirror-missing", "src/repro/core/vdes.py"),
                   ("mirror-stale", "src/repro_torch/core/vdes.py")}


# ------------------------------------------------------------- AST: layout

@pytest.mark.parametrize("rel,src,want", [
    ("ops/capacity.py", """
        CTRL_T_END = 3

        def compile(ctrl):
            ctrl[3] = 1.0          # hard-coded: must trigger
            ctrl[CTRL_T_END] = 1.0  # named: must not
            return ctrl
    """, ["layout-index", "layout-redef"]),
    ("ops/scenario.py", "def f(fleet):\n    return fleet.shape[0]\n", []),
    ("core/batching.py",
     "def f(trig):\n    return [trig[i] for i in range(6)]\n",
     ["layout-index"]),
    ("ops/capacity.py", "TRIG_FIELDS = 7\n", ["layout-redef"]),
    ("core/des.py", "TRIG_FIELDS = 7\n", []),
], ids=["index", "shape-exempt", "range-unpack", "redef", "owner"])
def test_layout_twin(tmp_path, rel, src, want):
    ref, port = twin(tmp_path, {rel: src})
    assert ref == port == want


def test_layout_index_hit_is_the_literal(tmp_path):
    fs = port_findings(tmp_path, {"src/repro_torch/ops/capacity.py": """
        def compile(ctrl):
            ctrl[3] = 1.0
            ctrl[CTRL_T_END] = 1.0
            return ctrl
    """})
    hits = [f for f in fs if f.rule == "layout-index"]
    assert len(hits) == 1 and "ctrl[3]" in hits[0].snippet


def test_layout_owner_value_must_equal_the_references(tmp_path):
    """Port-only: a layout constant the port's owner defines with another
    value than the reference's owner is a ``layout-redef``; the same value
    (``range`` unpacks and ``np.float32`` sentinels included) passes."""
    ref = ("import numpy as np\nTRIG_FIELDS = 6\n"
           "(TRIG_A, TRIG_B) = range(2)\nCTRL_INF = np.float32(3.0e38)\n")
    fs = port_findings(tmp_path / "same", {
        "src/repro/core/des.py": ref, "src/repro_torch/core/des.py": ref})
    assert rules_of(fs) == []
    fs = port_findings(tmp_path / "other", {
        "src/repro/core/des.py": ref,
        "src/repro_torch/core/des.py": ref.replace("range(2)",
                                                   "(1, 0)")})
    assert rules_of(fs) == ["layout-redef"]
    assert {f.message.split(" = ")[0] for f in fs} == {
        "layout constant TRIG_A", "layout constant TRIG_B"}


# ---------------------------------------------------------------- AST: fma

def test_engine_fma_reference_side(tmp_path):
    """The reference flags a bare ``a - b*c`` in an engine file (XLA may
    contract it); the port does not (two eager ops, each rounding)."""
    src = "def f(a, b, c):\n    return a - b * c\n"
    ref, port = twin(tmp_path, {"core/metrics.py": src})
    assert ref == ["engine-fma"] and port == []


def test_engine_fma_helper_and_index_arithmetic_twin(tmp_path):
    src = """
        from repro.core.numerics import fma_free_msub

        def f(a, b, c, row, n):
            x = fma_free_msub(a, b, c)     # rounded product: fine
            return x + row[4 * n + 1]      # integer index math: fine
    """
    ref, port = twin(tmp_path, {"core/metrics.py": src})
    assert ref == port == []


@pytest.mark.parametrize("expr", [
    "torch.addcmul(a, b, c)", "a.addcmul_(b, c)", "torch.lerp(a, b, c)",
    "torch.addmm(a, b, c)", "torch.baddbmm(a, b, c)",
    "torch.add(a, b, alpha=c)", "a.sub(b, alpha=2)", "torch.addcdiv(a, b, c)",
])
def test_engine_fma_port_triggers_on_fused_ops(tmp_path, expr):
    src = f"import torch\n\ndef f(a, b, c):\n    return {expr}\n"
    fs = port_findings(tmp_path, {"src/repro_torch/core/metrics.py": src})
    assert rules_of(fs) == ["engine-fma"]


def test_engine_fma_port_passes_plain_ops_and_unit_alpha(tmp_path):
    src = """
        import torch
        from repro_torch.core.numerics import fma_free_msub

        def f(a, b, c, row, n):
            x = fma_free_msub(a, b, c)
            y = a - b * c                  # two eager ops: fine
            z = torch.sub(a, b, alpha=1) + torch.add(a, b, alpha=-1.0)
            return x + y + z + row[4 * n + 1]
    """
    fs = port_findings(tmp_path, {"src/repro_torch/core/metrics.py": src})
    assert rules_of(fs) == []


def test_engine_fma_ignored_outside_engine_files(tmp_path):
    ref, port = twin(tmp_path, {"ops/failures.py":
                                "def f(a, b, c):\n    return a - b * c\n"})
    assert ref == port == []
    fs = port_findings(tmp_path / "p", {
        "src/repro_torch/ops/failures.py":
        "import torch\n\ndef f(a, b, c):\n"
        "    return torch.addcmul(a, b, c)\n"})
    assert rules_of(fs) == []


# ------------------------------------------------- AST: hot-f64 / defaults

def test_hot_f64_reference_side(tmp_path):
    """The reference flags ``float()`` in the vdes hot path
    (``simulate_to_trace`` exempt); the port does not: a wrapped Python
    scalar does not promote an f32 tensor."""
    src = """
        def simulate(x):
            return float(x)

        def simulate_to_trace(x):
            return float(x)    # host-side conversion: exempt
    """
    write_tree(str(tmp_path), {"src/repro/core/vdes.py": src})
    hits = [f for f in ref_audit_tree(str(tmp_path)) if f.rule == "hot-f64"]
    assert len(hits) == 1
    fs = port_findings(tmp_path / "p", {"src/repro_torch/core/vdes.py": """
        import torch

        def simulate_ensemble(x):
            return torch.where(x > 0, x, float("nan")) + float(x.shape[0])
    """})
    assert rules_of(fs) == []


def test_hot_f64_port_side(tmp_path):
    src = """
        import numpy as np
        import torch

        def simulate_ensemble(x):
            def _fleet_stage(s):
                return s.double()                     # must trigger
            return _fleet_stage(x).to(torch.float64)  # must trigger

        def wave_program(x):
            return np.float64(x)                      # must trigger

        def simulate_to_trace(x):
            return x.cpu().numpy().astype(np.float64)  # host-side: exempt

        def gain_order_bound(x):
            return torch.double                        # host-side: exempt
    """
    fs = port_findings(tmp_path, {"src/repro_torch/core/vdes.py": src})
    hits = [f for f in fs if f.rule == "hot-f64"]
    assert sorted(f.line for f in hits) == [7, 8, 11]


def test_mutable_default_twin(tmp_path):
    src = "def f(a=[]):\n    return a\n\ndef g(a=None):\n    return a\n"
    ref, port = twin(tmp_path, {"obs/spans.py": src})
    assert ref == port == ["mutable-default"]


def test_probe_reduce_twin(tmp_path):
    src = """
        import jax.numpy as jnp

        def simulate(x):
            def _probe_stage(s):
                return jnp.sum(s) + jnp.min(s)   # sum: trigger; min: fine
            return _probe_stage(x)

        def elsewhere(s):
            return jnp.sum(s)                    # not probe code: fine
    """
    write_tree(str(tmp_path), {"src/repro/core/vdes.py": src,
                               "src/repro_torch/core/vdes.py":
                               port_variant("core/vdes.py", src)})
    for fs in (ref_audit_tree(str(tmp_path)), audit_tree(str(tmp_path))):
        assert len([f for f in fs if f.rule == "probe-reduce"]) == 1


@pytest.mark.parametrize("src,want", [
    ("X = 1  # parity: allow(not-a-rule)\n", ["bad-pragma"]),
    ('"""Docs show `# parity: allow(bogus-rule)` syntax."""\nX = 1\n', []),
], ids=["bad-pragma", "docstring-is-not-a-pragma"])
def test_pragma_twin(tmp_path, src, want):
    ref, port = twin(tmp_path, {"core/trace.py": src})
    assert ref == port == want


def test_port_registry_renames():
    """The port's registry: no weak types in torch, the Pallas walk
    becomes the SASS rules; every other rule keeps its name."""
    assert set(RF.RULES) - set(F.RULES) == {"carry-weak-type",
                                            "pallas-opaque"}
    assert set(F.RULES) - set(RF.RULES) == {"kernel-opaque", "kernel-fma"}


# ------------------------------------------- pragmas, baseline, fingerprint

def test_pragma_suppresses_on_line_and_line_above(tmp_path):
    path = tmp_path / "src" / "repro_torch" / "core"
    path.mkdir(parents=True)
    (path / "metrics.py").write_text(
        "import torch\n"
        "def f(a, b, c, d, e, f2):\n"
        "    x = torch.addcmul(a, b, c)  # parity: allow(engine-fma)\n"
        "    # justified false positive  # parity: allow(engine-fma)\n"
        "    y = torch.addcmul(d, e, f2)\n"
        "    return torch.lerp(x, y, x)\n")
    fs = audit_tree(str(tmp_path))
    active, suppressed = F.split_suppressed(fs, str(tmp_path))
    assert len(suppressed) == 2          # same-line and line-above pragmas
    assert len(active) == 1              # the un-pragma'd return line
    assert active[0].snippet == "return torch.lerp(x, y, x)"


def test_pragma_for_wrong_rule_does_not_suppress(tmp_path):
    path = tmp_path / "src" / "repro_torch" / "core"
    path.mkdir(parents=True)
    (path / "metrics.py").write_text(
        "import torch\n"
        "def f(a, b, c):\n"
        "    return torch.addcmul(a, b, c)  # parity: allow(layout-index)\n")
    fs = audit_tree(str(tmp_path))
    active, suppressed = F.split_suppressed(fs, str(tmp_path))
    assert [f.rule for f in active] == ["engine-fma"]
    assert suppressed == []


def test_fingerprint_stable_across_line_shifts():
    a = F.Finding(rule="engine-fma", file="src/repro_torch/core/metrics.py",
                  line=10, message="m", snippet="return torch.lerp(a, b, c)")
    b = F.Finding(rule="engine-fma", file="src/repro_torch/core/metrics.py",
                  line=99, message="m", snippet="return torch.lerp(a, b, c)")
    c = F.Finding(rule="engine-fma", file="src/repro_torch/core/metrics.py",
                  line=10, message="m", snippet="return torch.lerp(a, b, d)")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != c.fingerprint
    # the same hash as the reference's for the same finding
    r = RF.Finding(rule=a.rule, file=a.file, line=a.line, message="m",
                   snippet=a.snippet)
    assert r.fingerprint == a.fingerprint


def test_baseline_round_trip(tmp_path):
    f1 = F.Finding(rule="engine-fma", file="x.py", line=1, message="m1",
                   snippet="s1")
    f2 = F.Finding(rule="layout-index", file="y.py", line=2, message="m2",
                   snippet="s2")
    path = str(tmp_path / "baseline.json")

    new, accepted, stale = F.reconcile([f1, f2], F.load_baseline(path))
    assert (len(new), len(accepted), len(stale)) == (2, 0, 0)

    F.write_baseline(path, [f1, f2])
    new, accepted, stale = F.reconcile([f1, f2], F.load_baseline(path))
    assert (len(new), len(accepted), len(stale)) == (0, 2, 0)

    new, accepted, stale = F.reconcile([f1], F.load_baseline(path))
    assert (len(new), len(accepted), len(stale)) == (0, 1, 1)
    assert stale[0]["fingerprint"] == f2.fingerprint


def test_baseline_version_mismatch_raises(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        F.load_baseline(str(path))


# ------------------------------------------------------------------- CLI

def test_cli_fail_then_baseline_then_stale(tmp_path):
    write_tree(str(tmp_path), {
        "src/repro_torch/core/metrics.py":
        "import torch\ndef f(a, b, c):\n    return torch.addcmul(a, b, c)\n",
    })
    baseline = str(tmp_path / "analysis_baseline_torch.json")
    report = str(tmp_path / "build" / "analysis_torch" / "ANALYSIS.json")
    argv = ["--root", str(tmp_path), "--baseline", baseline,
            "--json", report, "--passes", "ast"]

    assert main(argv) == 1
    with open(report) as fh:
        rep = json.load(fh)
    assert rep["n_unbaselined"] == 1
    assert rep["counts_by_rule"] == {"engine-fma": 1}

    assert main(argv + ["--write-baseline"]) == 0
    assert main(argv) == 0
    with open(report) as fh:
        assert json.load(fh)["n_unbaselined"] == 0

    (tmp_path / "src" / "repro_torch" / "core" / "metrics.py").write_text(
        "def f(a, b, c):\n    return a\n")
    assert main(argv) == 0
    with open(report) as fh:
        assert json.load(fh)["n_stale_baseline"] == 1


def test_cli_defaults_write_under_build(tmp_path):
    """Without ``--json`` the report goes to the root's
    ``build/analysis_torch/ANALYSIS.json`` and the baseline is read from
    ``analysis_baseline_torch.json``; the reference's files are
    untouched."""
    write_tree(str(tmp_path), {"src/repro_torch/core/trace.py": "X = 1\n"})
    assert main(["--root", str(tmp_path), "--passes", "ast"]) == 0
    assert (tmp_path / "build" / "analysis_torch" / "ANALYSIS.json").exists()
    assert not (tmp_path / "artifacts").exists()


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in F.RULES:
        assert rule in out
    assert "carry-weak-type" not in out and "pallas-opaque" not in out


# ------------------------------------------------------------ trace rules

def state(**kw):
    return {k: torch.as_tensor(v) for k, v in kw.items()}


def audit(fn, tmp_path, **kw):
    return rules_of(audit_step(fn, state(**kw), str(tmp_path), "synth"))


def test_while_fma_triggers_on_fused_ops(tmp_path):
    for fn in (lambda s: {"c": torch.addcmul(s["c"], s["c"], s["c"])},
               lambda s: {"c": torch.lerp(s["c"], s["c"] * 2, 0.5)},
               lambda s: {"c": torch.add(s["c"], s["c"], alpha=0.99)},
               lambda s: {"c": s["c"].sub(s["c"], alpha=2)}):
        assert "while-fma" in audit(fn, tmp_path, c=np.ones(3, np.float32))


def test_while_fma_clean_on_two_ops_and_integer_alpha(tmp_path):
    for fn, c in (
            (lambda s: {"c": fma_free_madd(s["c"], s["c"], 0.99, xp=torch)},
             np.ones(3, np.float32)),
            (lambda s: {"c": s["c"] + s["c"] * 0.99}, np.ones(3, np.float32)),
            (lambda s: {"c": torch.sub(s["c"], s["c"], alpha=1)},
             np.ones(3, np.float32)),
            (lambda s: {"c": torch.add(s["c"], s["c"], alpha=3)},
             np.ones(3, np.int32))):
        assert "while-fma" not in audit(fn, tmp_path, c=c)


def test_carry_f64_caught(tmp_path):
    step = lambda s: {"c": s["c"] + 1.0}   # noqa: E731
    assert audit(step, tmp_path, c=np.zeros(2, np.float64)) == [
        "carry-f64", "f64-const"]
    assert audit(step, tmp_path, c=np.zeros(2, np.float32)) == []


def test_f64_const_caught(tmp_path):
    assert audit(lambda s: {"c": (s["c"].double() * 2.0).float()}, tmp_path,
                 c=np.ones(2, np.float32)) == ["f64-const"]
    const = torch.ones(2, dtype=torch.float64)
    assert audit(lambda s: {"c": s["c"] + const.float()}, tmp_path,
                 c=np.ones(2, np.float32)) == ["f64-const"]
    assert audit(lambda s: {"c": s["c"] * 2.0}, tmp_path,
                 c=np.ones(2, np.float32)) == []


def test_loop_reduce_float_triggers_int_passes(tmp_path):
    assert "loop-reduce" in audit(
        lambda s: {"c": torch.stack([s["c"], s["c"]]).sum(0)}, tmp_path,
        c=np.ones(3, np.float32))
    assert "loop-reduce" in audit(
        lambda s: {"c": s["c"].index_add(0, s["i"], s["c"])}, tmp_path,
        c=np.ones(3, np.float32), i=np.array([0, 0, 1]))
    assert "loop-reduce" in audit(
        lambda s: {"c": s["c"] @ s["c"]}, tmp_path,
        c=np.ones((2, 2), np.float32))
    assert "loop-reduce" not in audit(
        lambda s: {"c": (s["c"] > 0).sum(0, dtype=torch.int32)
                   + s["c"].amax(0).to(torch.int32)}, tmp_path,
        c=np.ones((3, 2), np.float32))


def test_unguarded_div_triggers_guarded_passes(tmp_path):
    c, d = np.ones(2, np.float32), np.full(2, 3.0, np.float32)
    assert "unguarded-div" in audit(
        lambda s: {"c": s["c"] / (s["d"] - 1.0)}, tmp_path, c=c, d=d)
    zero = torch.tensor([2.0, 0.0])
    assert "unguarded-div" in audit(
        lambda s: {"c": s["c"] / zero}, tmp_path, c=c, d=d)
    for fn in (lambda s: {"c": s["c"] / guarded_denominator(s["d"] - 1.0,
                                                            xp=torch)},
               lambda s: {"c": s["c"] / (s["d"] - 1.0).clamp(min=1.0)
                          .unsqueeze(0)[0]},
               lambda s: {"c": s["c"] / 3.0},
               lambda s: {"c": s["c"] / torch.tensor([2.0, 4.0])}):
        assert "unguarded-div" not in audit(fn, tmp_path, c=c, d=d)


def test_unguarded_log_triggers_clamped_passes(tmp_path):
    c = np.full(2, 2.0, np.float32)
    assert "unguarded-log" in audit(
        lambda s: {"c": s["c"] + torch.log(s["c"])}, tmp_path, c=c)
    assert "unguarded-log" in audit(
        lambda s: {"c": torch.rsqrt(s["c"] - 2.0)}, tmp_path, c=c)
    assert "unguarded-log" not in audit(
        lambda s: {"c": s["c"] + torch.log(torch.maximum(
            s["c"], torch.tensor(1e-6)))}, tmp_path, c=c)


def test_trace_refuses_a_host_read(tmp_path):
    """A wave that reads a value back to the host cannot be traced: the
    pass raises (the CLI's exit 2), it never passes."""
    with pytest.raises(Exception):
        audit_step(lambda s: {"c": s["c"] * float(s["c"].sum())},
                   state(c=np.ones(2, np.float32)), str(tmp_path), "synth")


# ------------------------------------------------------- the real tree

def test_clean_tree_ast_audit_is_clean():
    """The port's sources carry zero unbaselined AST findings (every
    surviving site is pragma-suppressed with a justification)."""
    fs = audit_tree(str(REPO_ROOT))
    active, suppressed = F.split_suppressed(fs, str(REPO_ROOT))
    assert active == [], [f.render() for f in active]
    assert {f.rule for f in suppressed} <= {"layout-index", "probe-reduce"}


@pytest.fixture(scope="module")
def smoke_call():
    with capture_calls() as calls:
        run_experiment(smoke_spec(engine="torch"), device="cpu")
    assert len(calls) == 1
    return calls[0]


def test_clean_tree_trace_audit_is_clean():
    """Tracing one wave of the production calls (the smoke spec, every
    stage on, and a 2-point sweep of it) on the CPU yields zero
    unbaselined findings: the one surviving reduction is the pragma'd
    redeploy-gain sum (one nonzero term per sum; see vdes._redeploy)."""
    fs = run_jaxpr_audit(str(REPO_ROOT), device="cpu")
    active, suppressed = F.split_suppressed(fs, str(REPO_ROOT))
    assert active == [], [f.render() for f in active]
    assert {f.rule for f in suppressed} == {"loop-reduce"}
    assert {(f.file, f.snippet) for f in suppressed} == {(
        "src/repro_torch/core/vdes.py",
        "by_rank = kth.sum(1)  # parity: allow(loop-reduce)")}


def test_cli_on_the_tree_exits_0(tmp_path):
    """``python -m repro_torch.analysis --device cpu`` with the AST and
    trace passes (the recompile pass has its own file)."""
    assert main(["--root", str(REPO_ROOT), "--device", "cpu", "--passes",
                 "ast,jaxpr", "--json", str(tmp_path / "a.json")]) == 0
    rep = json.loads((tmp_path / "a.json").read_text())
    assert rep["n_unbaselined"] == 0 and rep["n_suppressed"] == 3


# ------------------------------------------------------- mutated copies

MUTATIONS = {
    # a renamed stage: its marker goes stale, the new name has none
    "renamed-stage": (lambda s: s.replace("_fleet_stage", "_lifecycle_stage"),
                      {"mirror-missing", "mirror-stale"}),
    # a fused multiply-add in the completion stage
    "addcmul": (lambda s: s.replace(
        "delay = torch.minimum(bo0 * torch.pow(bo1, att.to(f32)), bo2)",
        "delay = torch.minimum(torch.addcmul(torch.zeros_like(bo0), bo0, "
        "torch.pow(bo1, att.to(f32))), bo2)"), {"engine-fma"}),
    # an f64 exponent in the completion stage
    "double": (lambda s: s.replace(
        "delay = torch.minimum(bo0 * torch.pow(bo1, att.to(f32)), bo2)",
        "delay = torch.minimum(bo0 * torch.pow(bo1, att.double()), bo2)"),
        {"hot-f64"}),
}


def mutated_tree(tmp_path, mutate):
    """A scratch copy of the port (and of the reference's des/vdes/metrics
    the AST pass reads) with ``vdes.py`` mutated."""
    root = tmp_path / "tree"
    shutil.copytree(REPO_ROOT / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in ("des.py", "vdes.py", "metrics.py"):
        dst = root / "src" / "repro" / "core" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO_ROOT / "src" / "repro" / "core" / rel, dst)
    path = root / "src" / "repro_torch" / "core" / "vdes.py"
    src = path.read_text()
    new = mutate(src)
    assert new != src
    path.write_text(new)
    return root, path


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutated_copy_is_caught_by_the_cli(tmp_path, name):
    mutate, want = MUTATIONS[name]
    root, _ = mutated_tree(tmp_path, mutate)
    report = tmp_path / "a.json"
    assert main(["--root", str(root), "--passes", "ast",
                 "--json", str(report)]) == 1
    rep = json.loads(report.read_text())
    assert {f["rule"] for f in rep["unbaselined"]} == want


@pytest.mark.parametrize("name,want", [("addcmul", "while-fma"),
                                       ("double", "f64-const")])
def test_mutated_copy_is_caught_by_the_trace(tmp_path, monkeypatch,
                                             smoke_call, name, want):
    """The mutant's wave program, traced on the smoke spec's captured
    call: the fused op is found at the mutated line, and the f64 values
    from there on (the mutated line among them)."""
    import importlib.util
    root, path = mutated_tree(tmp_path, MUTATIONS[name][0])
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.core._vdes_{name.replace('-', '_')}", path)
    mutant = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mutant)
    spec.loader.exec_module(mutant)
    monkeypatch.setattr(vdes, "wave_program", mutant.wave_program)
    fs, _ = audit_call(smoke_call, str(root), "mutant")
    hits = [f for f in fs if f.rule == want]
    assert hits and {f.file for f in hits} == {"src/repro_torch/core/vdes.py"}
    assert any("delay = torch.minimum(" in f.snippet for f in hits)
    if want == "while-fma":
        assert len(hits) == 1


def test_finding_keys_drop_the_trace_label_and_card_rules():
    a = F.Finding("loop-reduce", "f.py", 3, "x [traced via a]", "s")
    b = F.Finding("loop-reduce", "f.py", 3, "x [traced via b[dense]]", "s")
    c = F.Finding("recompile", "", 0, "m [traced via a]")
    d = F.Finding("kernel-fma", "k.cu", 0, "fn: 2 FFMA")
    assert finding_keys([a, c]) == finding_keys([b, c, d])
    assert finding_keys([a]) != finding_keys([c])
