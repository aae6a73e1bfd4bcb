"""Recompile pass: prove a mixed Sweep grid stays ONE engine call and ONE
wave program (mirrors :mod:`repro.analysis.recompile_audit`).

The PR 2 bug class: an axis value that reaches ``vdes.simulate_ensemble``
as a static argument (or as a shape), or that the engine dispatches point
by point, splits the grid into separate runs. On the reference that costs
an XLA compile per point; on the eager port it costs a wave loop per point
(each a host-dispatch-bound loop of hundreds of operations per wave). The
audit runs a representative mixed grid (capacity x controller x trigger x
probe x reliability — :func:`repro_torch.analysis.harness.smoke_sweep`)
through the production ``Sweep.run`` path with the capture shim on, then
checks:

1. the grid produced exactly ONE ``simulate_ensemble`` call;
2. every captured call has the same signature (static arguments by value,
   array arguments by shape and dtype);
3. slicing each batch row out of the captured call and recording one
   wave of it alone gives the same program hash
   (:func:`repro_torch.analysis.jaxpr_audit.program_hash`: the operations,
   their dataflow and literals — what the trace pass's FX graph holds, at
   a fraction of ``make_fx``'s cost per row) — every axis value lives in
   the batch *tensors*, none in the program's Python control flow or
   literals;
4. on the card, the grid loaded at most one kernel library, and every
   loaded library is its kernel's current build (one per kernel).

Violations come back as ``recompile`` findings (no source site — they are
properties of the lowering, not of a line).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.harness import (CapturedCall, call_signature,
                                          capture_calls, smoke_sweep)
from repro_torch.device import resolve_device


def _batch_rows(call: CapturedCall) -> int:
    return int(call.arguments()["arrival"].shape[0])


def _slice_row(call: CapturedCall, b: int) -> CapturedCall:
    """Row ``b`` of a batched call, batch dim kept (R=1)."""
    rows = _batch_rows(call)

    def cut(v):
        if hasattr(v, "shape") and len(getattr(v, "shape", ())) >= 1 \
                and v.shape[0] == rows:
            return v[b:b + 1]
        return v
    return CapturedCall(tuple(cut(a) for a in call.args),
                        {k: cut(v) for k, v in call.kwargs.items()})


def row_program_hash(call: CapturedCall) -> str:
    """Hash of the program one wave of the call's wave program runs
    (:func:`repro_torch.analysis.jaxpr_audit.program_hash`)."""
    from repro_torch.analysis.jaxpr_audit import program_hash
    prog = call.program()
    return program_hash(prog.wave, prog.state)


def run_recompile_audit(root: str, sweep=None,
                        runner: Optional[Callable] = None,
                        hash_rows: bool = True,
                        device=None) -> List[Finding]:
    """Audit one Sweep grid (default: the representative mixed smoke grid)
    on ``device`` (``None``: the card). ``runner(sweep)`` executes it —
    tests inject doctored runners to seed per-point-dispatch hazards."""
    from repro_torch.kernels import _build

    dev = resolve_device(device)
    sweep = sweep if sweep is not None else smoke_sweep()
    runner = runner if runner is not None else (
        lambda sw: sw.run(device=dev))
    n_points = len(sweep.points())

    libs_before = dict(_build._libs)
    with capture_calls() as calls:
        runner(sweep)
    libs_after = dict(_build._libs)

    findings: List[Finding] = []

    def fail(message: str) -> None:
        findings.append(Finding(rule="recompile", file="", line=0,
                                message=message))

    if not calls:
        fail(f"the {n_points}-point audit grid never reached "
             "simulate_ensemble — the batched sweep path is dead")
        return findings

    if len(calls) != 1:
        fail(f"the {n_points}-point audit grid lowered to {len(calls)} "
             "simulate_ensemble calls instead of 1 — per-point dispatch is "
             "back")

    keys = {}
    for i, call in enumerate(calls):
        keys.setdefault(call_signature(call), []).append(i)
    if len(keys) > 1:
        statics = sorted({repr(k[2]) for k in keys})
        fail(f"{len(keys)} distinct call signatures across the audit "
             f"grid's calls — an axis value became part of the program "
             f"(static arguments seen: {', '.join(statics)})")

    if hash_rows and len(calls) == 1:
        rows = _batch_rows(calls[0])
        hashes = {row_program_hash(_slice_row(calls[0], b))
                  for b in range(rows)}
        if len(hashes) > 1:
            fail(f"recording the {rows} batch rows alone yields "
                 f"{len(hashes)} distinct wave programs — an axis value is "
                 "baked into the program instead of riding the batch "
                 "tensors")
    elif len(calls) > 1:
        hashes = {row_program_hash(call) for call in calls}
        if len(hashes) > 1:
            fail(f"the grid's {len(calls)} calls run {len(hashes)} "
                 "distinct wave programs")

    new = sorted(set(libs_after) - set(libs_before))
    if len(new) > 1:
        fail(f"the grid loaded {len(new)} kernel libraries ({', '.join(new)}),"
             " expected at most 1 (the admission kernel)")
    for name, lib in sorted(libs_after.items()):
        if lib._name != str(_build.library_path(name)):
            fail(f"the loaded {name} library {lib._name} is not the "
                 "kernel's current build: more than one library per kernel")
    return findings
