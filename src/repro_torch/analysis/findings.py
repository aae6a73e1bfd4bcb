"""Finding model, pragma suppression, baseline file and the JSON report
(mirrors :mod:`repro.analysis.findings`).

The three passes of the port's auditor (:mod:`repro_torch.analysis.ast_audit`,
:mod:`repro_torch.analysis.jaxpr_audit`,
:mod:`repro_torch.analysis.recompile_audit`) emit :class:`Finding` rows;
this module owns everything downstream of them:

- **pragmas** — ``# parity: allow(<rule>[, <rule>...])`` on the finding's
  line or the line immediately above suppresses it in place (the reviewed
  false-positive workflow; each pragma carries a one-line justification);
- **baseline** — a checked-in JSON file of accepted fingerprints
  (``analysis_baseline_torch.json``; the reference keeps its own
  ``analysis_baseline.json``): findings in the baseline pass, findings not
  in it fail, baseline entries no longer produced warn as *stale*;
- **fingerprints** — stable across pure line-number shifts: the hash covers
  the rule, the file, and the stripped source line (or the message for
  findings with no source site), not the line number;
- **report** — the machine-readable ``build/analysis_torch/ANALYSIS.json``
  (the reference's ``artifacts/ANALYSIS.json`` is never written).

The rule registry is the port's own: eager PyTorch has no weak types (no
``carry-weak-type``), the reference's walk into the Pallas kernel body
becomes ``kernel-fma`` (the CUDA kernels' SASS) and ``kernel-opaque``, and
the FMA rules look for fused multiply-add *operations*, because an eager
``a - b*c`` is two rounded kernels (:mod:`repro_torch.core.numerics`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Sequence, Tuple

#: every rule the analyzer can emit, with a one-line description. Pragmas
#: naming a rule outside this registry raise a ``bad-pragma`` finding.
RULES: Dict[str, str] = {
    # --- trace pass (repro_torch.analysis.jaxpr_audit) ---
    "while-fma": ("fused multiply-add operation (addcmul, addcdiv, lerp, "
                  "addmm, addmv, addbmm, baddbmm, or add/sub with alpha "
                  "other than +-1) in the traced wave body: one ATen kernel "
                  "that may keep the exact product, where numpy rounds it "
                  "first — write the product and the add as two ops "
                  "(repro_torch.core.numerics.fma_free_madd/msub)"),
    "carry-f64": ("float64 tensor in the wave loop's state dict: the "
                  "engines' contract is f32 op-for-op parity"),
    "f64-const": ("float64 value anywhere in the traced wave body (a "
                  "constant, a conversion or an op's result)"),
    "loop-reduce": ("order-sensitive float reduction (sum / mean / prod / "
                    "cumsum / scatter_add / index_add / accumulating "
                    "index_put / mm / bmm / matmul) in the traced wave body: "
                    "CUDA reduces in another order than numpy (and "
                    "scatter/index adds in no fixed order) — prefer min/max "
                    "or integer counts, or pragma with the proof"),
    "unguarded-div": ("float division in the traced wave body whose "
                      "denominator does not come from clamp / maximum / "
                      "minimum / where (or a nonzero constant): batched "
                      "padding rows mint NaN/inf the numpy mirror never "
                      "computes — use repro_torch.core.numerics."
                      "guarded_denominator"),
    "unguarded-log": ("log / log1p / rsqrt in the traced wave body whose "
                      "operand is not clamped away from zero"),
    "kernel-opaque": ("a CUDA kernel ran inside the traced wave body (its "
                      "ctypes launch is invisible to the trace) and its "
                      "library's SASS could not be read: the kernel went "
                      "unaudited"),
    "kernel-fma": ("FFMA / DFMA / HFMA2 instruction in the SASS of an "
                   "engine kernel whose parity is exact (fused_admission, "
                   "queue_scan): nvcc contracted a multiply-add — use "
                   "__fmul_rn/__fadd_rn or build that kernel with "
                   "-fmad=false"),
    # --- recompile pass (repro_torch.analysis.recompile_audit) ---
    "recompile": ("a Sweep grid did not reach simulate_ensemble as one "
                  "call with one signature and one traced program, or "
                  "loaded a kernel library more than once: per-point "
                  "dispatch is back (the PR 2 bug class)"),
    # --- ast pass (repro_torch.analysis.ast_audit) ---
    "engine-fma": ("fused multiply-add call (torch addcmul / addcdiv / "
                   "lerp / addmm / addmv / addbmm / baddbmm, or add/sub "
                   "with alpha= other than the literal +-1) in an engine "
                   "file; a bare `a - b*c` is two rounded eager ops and "
                   "passes"),
    "layout-index": ("hard-coded integer field index into a layout tensor "
                     "(ctrl/trig/probe/fleet/header): use the named "
                     "constants from repro_torch.core.des / "
                     "repro_torch.core.metrics"),
    "layout-redef": ("layout constant redefined outside its owning module "
                     "(repro_torch.core.des / repro_torch.core.metrics), or "
                     "an owner's value that differs from the reference's "
                     "(repro.core.des / repro.core.metrics, read as text)"),
    "mirror-missing": ("a wave stage of the port's simulate_ensemble has "
                       "no `# mirror: vdes.<stage>` marker in the "
                       "port's des.py, or a stage of the reference's "
                       "vdes.simulate has no counterpart in the port"),
    "mirror-stale": ("the port's des.py carries a mirror marker for a "
                     "stage the port does not have, or the port has a "
                     "stage the reference's vdes.simulate lacks"),
    "hot-f64": ("torch.float64 / torch.double / .double() / np.float64 in "
                "the engine's functions in vdes.py (simulate_ensemble, its "
                "builder wave_program, simulate; the host-side "
                "simulate_to_trace and gain_order_bound are exempt): "
                "promotes f32 parity state to f64"),
    "mutable-default": "mutable default argument (list/dict/set literal)",
    "probe-reduce": ("sum/mean-class reduction in a probe channel: the "
                     "batched and numpy reduction orders differ — probe "
                     "channels must use order-independent min/max"),
    "bad-pragma": "a parity pragma names a rule the analyzer does not have",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding. ``file`` is repo-relative (posix); ``line`` is
    1-based (0 = no source site, e.g. a recompile finding). ``snippet`` is
    the stripped source line — the fingerprint hashes it instead of the
    line number, so pure line shifts don't invalidate baselines."""

    rule: str
    file: str
    line: int
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        basis = f"{self.rule}|{self.file}|{self.snippet or self.message}"
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    @property
    def location(self) -> str:
        if not self.file:
            return "<no-source>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_dict(self) -> dict:
        return dict(rule=self.rule, file=self.file, line=self.line,
                    message=self.message, snippet=self.snippet,
                    fingerprint=self.fingerprint)

    def render(self) -> str:
        return f"{self.location}: [{self.rule}] {self.message}"


# --------------------------------------------------------------- pragmas

PRAGMA_RE = re.compile(r"#\s*parity:\s*allow\(([^)]*)\)")


def pragma_rules(src_lines: Sequence[str]) -> Dict[int, set]:
    """``{1-based line: {rule, ...}}`` for every pragma comment in a file.

    Only real ``COMMENT`` tokens count — pragma-shaped text inside strings
    and docstrings (e.g. documentation showing the syntax) is ignored. On
    files that do not tokenize (fixtures mid-edit) every line is matched."""
    import io
    import tokenize

    out: Dict[int, set] = {}

    def add(lineno: int, text: str) -> None:
        m = PRAGMA_RE.search(text)
        if m:
            out[lineno] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}

    src = "\n".join(src_lines) + "\n"
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                add(tok.start[0], tok.string)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        out.clear()
        for i, text in enumerate(src_lines, start=1):
            add(i, text)
    return out


def bad_pragma_findings(path: str, src_lines: Sequence[str]) -> List[Finding]:
    """``bad-pragma`` findings for pragmas naming unknown rules."""
    out = []
    for line, rules in pragma_rules(src_lines).items():
        unknown = sorted(r for r in rules if r not in RULES)
        if unknown:
            out.append(Finding(
                rule="bad-pragma", file=path, line=line,
                message=f"pragma names unknown rule(s): {', '.join(unknown)}",
                snippet=src_lines[line - 1].strip()))
    return out


def split_suppressed(findings: Iterable[Finding], root: str
                     ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (active, suppressed-by-pragma). A pragma on the
    finding's own line or the line immediately above covers it."""
    cache: Dict[str, Dict[int, set]] = {}
    active, suppressed = [], []
    for f in findings:
        if not f.file or not f.line:
            active.append(f)
            continue
        if f.file not in cache:
            full = os.path.join(root, f.file)
            try:
                with open(full) as fh:
                    cache[f.file] = pragma_rules(fh.read().splitlines())
            except OSError:
                cache[f.file] = {}
        pragmas = cache[f.file]
        allowed = pragmas.get(f.line, set()) | pragmas.get(f.line - 1, set())
        (suppressed if f.rule in allowed else active).append(f)
    return active, suppressed


def unique(findings: Iterable[Finding]) -> List[Finding]:
    """One finding per fingerprint and line: the same site can surface
    from several traces (the smoke spec and a sweep of it, the kernel and
    the plain admission)."""
    seen, out = set(), []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -------------------------------------------------------------- baseline

BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, dict]:
    """``{fingerprint: entry}`` from a baseline file; {} when absent."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: unsupported baseline version {data.get('version')!r} "
            f"(expected {BASELINE_VERSION})")
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = sorted((f.to_dict() for f in findings),
                     key=lambda e: (e["file"], e["rule"], e["line"]))
    with open(path, "w") as fh:
        json.dump({"version": BASELINE_VERSION, "findings": entries}, fh,
                  indent=2, sort_keys=True)
        fh.write("\n")


def reconcile(findings: Sequence[Finding], baseline: Dict[str, dict]
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """``(new, accepted, stale)``: findings not in the baseline (fail),
    findings covered by it (pass), and baseline entries nothing produced
    any more (warn — prune them with ``--write-baseline``)."""
    new, accepted = [], []
    seen = set()
    for f in findings:
        fp = f.fingerprint
        seen.add(fp)
        (accepted if fp in baseline else new).append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in seen]
    return new, accepted, stale


# ---------------------------------------------------------------- report

REPORT_VERSION = 1


def build_report(*, passes: Sequence[str], new: Sequence[Finding],
                 accepted: Sequence[Finding], suppressed: Sequence[Finding],
                 stale: Sequence[dict]) -> dict:
    """The machine-readable analyzer verdict
    (``build/analysis_torch/ANALYSIS.json``). ``n_unbaselined`` is the
    gate: the CLI exits 1 on nonzero."""
    counts: Dict[str, int] = {}
    for f in list(new) + list(accepted) + list(suppressed):
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": REPORT_VERSION,
        "passes": list(passes),
        "n_unbaselined": len(new),
        "n_baselined": len(accepted),
        "n_suppressed": len(suppressed),
        "n_stale_baseline": len(stale),
        "counts_by_rule": counts,
        "unbaselined": [f.to_dict() for f in new],
        "baselined": [f.to_dict() for f in accepted],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_baseline": list(stale),
    }


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")


def relpath(path: str, root: str) -> str:
    """Repo-relative posix path for Finding.file."""
    return os.path.relpath(os.path.abspath(path),
                           os.path.abspath(root)).replace(os.sep, "/")
