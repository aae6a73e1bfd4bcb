"""Parity auditor for the port (mirrors :mod:`repro.analysis`): analysis
that proves the port's engine keeps the reference's bit parity and its
sweeps stay one call, before the numbers are compared.

Three passes over the port's simulator (see the README's port section):

- :mod:`repro_torch.analysis.jaxpr_audit` — traces one wave of the
  production ``simulate_ensemble`` calls (``vdes.wave_program``) into an FX
  graph and walks it for fused multiply-add operations, f64 values in the
  state or the body, order-sensitive float reductions and unguarded
  div/log; on the card it also reads the engine kernels' SASS for FMA
  instructions (the file keeps the reference's name);
- :mod:`repro_torch.analysis.recompile_audit` — runs a representative
  mixed Sweep grid and proves it is one engine call whose rows trace to
  one wave program;
- :mod:`repro_torch.analysis.ast_audit` — pure-AST structure checks: every
  wave stage has a marked numpy mirror in the port's des.py, layout
  constants have one source and the reference's values, plus the port's
  lint rules.

Findings are gated by inline ``# parity: allow(<rule>)`` pragmas and the
checked-in ``analysis_baseline_torch.json``; the CLI (``python -m
repro_torch.analysis``) writes ``build/analysis_torch/ANALYSIS.json`` and
exits nonzero on any unbaselined finding. The package imports torch,
numpy and the port, never JAX and never the reference package: the
reference's sources are read as text.
"""
from repro_torch.analysis.findings import (BASELINE_VERSION, Finding, RULES,
                                           build_report, load_baseline,
                                           reconcile, split_suppressed,
                                           write_baseline, write_report)

__all__ = [
    "BASELINE_VERSION", "Finding", "RULES", "build_report", "load_baseline",
    "reconcile", "split_suppressed", "write_baseline", "write_report",
]
