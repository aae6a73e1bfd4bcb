"""CLI driver: ``python -m repro_torch.analysis`` (mirrors
:mod:`repro.analysis.__main__`).

Runs the requested passes, applies pragma suppression and the checked-in
baseline (``analysis_baseline_torch.json``), prints a human summary, writes
``build/analysis_torch/ANALYSIS.json``, and exits:

- ``0`` — clean, or only baselined/suppressed findings (stale baseline
  entries warn but do not fail);
- ``1`` — at least one unbaselined finding;
- ``2`` — the analyzer itself failed (a wave that needs a host read and
  cannot be traced, a missing card, a broken engine).

The trace and recompile passes run the engine on ``--device`` (default:
the card, which they require unless ``--device cpu`` is given); the AST
pass runs no code. On the card the trace pass also prints the FMA counts
of the five kernel libraries' SASS and each traced wave's operation
counts. ``--write-baseline`` accepts the current findings (rewriting the
baseline with every active finding and pruning stale entries);
``--list-rules`` prints the rule registry.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Callable, List, Optional

from repro_torch.analysis import findings as F

PASSES = ("ast", "jaxpr", "recompile")


def _default_root() -> str:
    # src/repro_torch/analysis/__main__.py -> the repository root
    here = os.path.abspath(__file__)
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def collect(root: str, passes, device=None,
            report: Optional[Callable] = None) -> List[F.Finding]:
    out: List[F.Finding] = []
    if "ast" in passes:
        from repro_torch.analysis.ast_audit import audit_tree
        out += audit_tree(root)
    if "jaxpr" in passes:
        from repro_torch.analysis.jaxpr_audit import run_jaxpr_audit
        out += run_jaxpr_audit(root, device=device, report=report)
    if "recompile" in passes:
        from repro_torch.analysis.recompile_audit import run_recompile_audit
        out += run_recompile_audit(root, device=device)
    return F.unique(out)


def print_report(what: str, value, prefix: str = "") -> None:
    """Prints what the trace pass reports: a traced wave's operation
    counts by kind, or the kernel libraries' SASS FMA counts per kernel
    function."""
    if what == "sass":
        for lib, fns in value.items():
            for fn, c in fns.items():
                print(f"{prefix}sass {lib} {fn}: " + ", ".join(
                    f"{n} {op}" for op, n in c.items()), flush=True)
    else:
        print(f"{prefix}{what}: {sum(value.values())} operations ("
              + ", ".join(f"{k} {n}" for k, n in value.items()) + ")",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="parity auditor for the port: traced wave + SASS + AST")
    ap.add_argument("--root", default=_default_root(),
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/"
                         "analysis_baseline_torch.json)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="report path (default: <root>/build/"
                         "analysis_torch/ANALYSIS.json)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma list from {{{','.join(PASSES)}}}")
    ap.add_argument("--device", default=None,
                    help="device the trace and recompile passes run the "
                         "engine on (default: the card; 'cpu' to ask for "
                         "the CPU)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings into the baseline")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(F.RULES):
            print(f"{rule:18s} {F.RULES[rule]}")
        return 0

    root = os.path.abspath(args.root)
    baseline_path = args.baseline or os.path.join(
        root, "analysis_baseline_torch.json")
    json_out = args.json_out or os.path.join(root, "build", "analysis_torch",
                                             "ANALYSIS.json")
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {', '.join(unknown)}")

    try:
        raw = collect(root, passes, device=args.device, report=print_report)
        active, suppressed = F.split_suppressed(raw, root)
        baseline = F.load_baseline(baseline_path)
        new, accepted, stale = F.reconcile(active, baseline)

        if args.write_baseline:
            F.write_baseline(baseline_path, active)
            print(f"baseline: wrote {len(active)} finding(s) to "
                  f"{baseline_path} (pruned {len(stale)} stale)")
            new, accepted, stale = [], list(active), []

        report = F.build_report(passes=passes, new=new, accepted=accepted,
                                suppressed=suppressed, stale=stale)
        F.write_report(json_out, report)
    except Exception:
        traceback.print_exc()
        print("analysis: internal error (exit 2)", file=sys.stderr)
        return 2

    for f in new:
        print(f"FAIL {f.render()}")
    for e in stale:
        print(f"warn: stale baseline entry {e.get('fingerprint')} "
              f"({e.get('rule')} @ {e.get('file')}) — prune with "
              "--write-baseline")
    print(f"analysis: {len(new)} unbaselined, {len(accepted)} baselined, "
          f"{len(suppressed)} pragma-suppressed, {len(stale)} stale "
          f"baseline entr{'y' if len(stale) == 1 else 'ies'} "
          f"[passes: {', '.join(passes)}] -> {json_out}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
