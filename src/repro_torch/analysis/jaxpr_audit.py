"""Trace pass: trace the real engine's wave body, prove it is parity-safe
(mirrors :mod:`repro.analysis.jaxpr_audit`; the file keeps the reference's
name, and the program it walks is the traced wave body, not a jaxpr).

The reference traces ``vdes.simulate`` into a jaxpr and walks its
``while`` body. The port's loop is eager: its body is
``vdes.wave_program(...).wave``, a pure function of a dict of tensors with
no host read. The pass replays a captured production call of
``simulate_ensemble`` (:mod:`repro_torch.analysis.harness`), builds its
wave program and traces one wave with
``torch.fx.experimental.proxy_tensor.make_fx(tracing_mode="real")`` on the
call's device, then walks the FX graph (ATen operations) for:

- **while-fma** — a fused multiply-add operation (``addcmul``,
  ``addcdiv``, ``lerp``, ``addmm``, ``addmv``, ``addbmm``, ``baddbmm``) or
  a float ``add``/``sub`` with ``alpha`` other than ±1: one kernel that may
  keep the exact product where numpy rounds it first;
- **carry-f64** — an f64 tensor in the wave's state dict;
- **f64-const** — any f64 value in the traced body (a constant, a
  conversion, an op's result);
- **loop-reduce** — an order-sensitive float reduction (sum / mean / prod
  / cumsum / scatter_add / index_add / accumulating index_put / mm / bmm /
  matmul): legal only when the numpy mirror provably agrees (pragma with
  the proof). Integer reductions are exact in any order and pass;
- **unguarded-div / unguarded-log** — a float ``div`` (``log`` / ``log1p``
  / ``rsqrt``) whose denominator (operand) does not come from ``clamp`` /
  ``maximum`` / ``minimum`` / ``where``, looking through views,
  ``unsqueeze``, ``expand``, ``_to_copy`` and ``clone``. A constant of the
  traced program (a Python scalar, or a tensor the set-up computed before
  the loop, such as the guarded seasonal period) is guarded when none of
  its values is zero (negative or zero for a log), as the reference treats
  a literal.

Findings carry the innermost ``repro_torch`` source line of the operation
(a dispatch mode records the Python stack beside each node the tracer
creates), so pragmas and baselines attach to engine code.

On the card the admission stage launches its CUDA kernel through
``ctypes``, which the trace cannot see: :func:`sass_audit` reads the
engine kernels' SASS (``cuobjdump -sass``) and reports every FFMA / DFMA /
HFMA2 as **kernel-fma** — the port's counterpart of the reference's walk
into the Pallas kernel body. A kernel that ran inside a traced wave and
whose SASS was not read is **kernel-opaque**. A wave that needs a host
read makes ``make_fx`` raise: an analyzer error, never a pass.
"""
from __future__ import annotations

import hashlib
import itertools
import linecache
import os
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.harness import (CapturedCall, capture_calls,
                                          smoke_spec)
from repro_torch.device import resolve_device

# fused multiply-add operations (in-place forms strip their "_")
FMA_OPS = {"addcmul", "addcdiv", "lerp", "addmm", "addmv", "addbmm",
           "baddbmm"}
ALPHA_OPS = {"add", "sub", "rsub"}
# order-sensitive float reductions
REDUCE_OPS = {"sum", "nansum", "mean", "nanmean", "prod", "cumsum",
              "cumprod", "scatter_add", "index_add", "mm", "bmm", "matmul",
              "dot", "mv"}
ACCUMULATE_OPS = {"index_put", "_index_put_impl"}
SCATTER_REDUCE_OPS = {"scatter_reduce", "index_reduce"}
# a denominator/operand produced (through shape plumbing) by one of these
# is guarded
GUARD_OPS = {"clamp", "clamp_min", "clamp_max", "maximum", "minimum",
             "where", "fmax", "fmin"}
TRANSPARENT_OPS = {"view", "_unsafe_view", "reshape", "unsqueeze",
                   "squeeze", "expand", "_to_copy", "clone", "alias",
                   "detach", "select", "slice", "permute", "t", "contiguous",
                   "lift_fresh", "lift_fresh_copy"}
LOG_OPS = {"log", "log1p", "rsqrt", "log2", "log10"}

# engine kernels held exact (kernel-fma gates them) and float kernels held
# to tolerances (their SASS FMA counts are printed, not gated)
ENGINE_KERNELS = ("fused_admission", "queue_scan")
FLOAT_KERNELS = ("gmm_logpdf", "flash_attention", "mamba2_scan")
FMA_OPCODES = ("FFMA", "DFMA", "HFMA2")

# the rules only a card run can raise: a CPU run launches no kernel
CARD_ONLY_RULES = ("kernel-fma", "kernel-opaque")

_PORT_DIR = os.sep + "repro_torch" + os.sep
_ANALYSIS_DIR = _PORT_DIR + "analysis" + os.sep


# ------------------------------------------------------------- tracing

class _Sites(TorchDispatchMode):
    """Entered inside the traced function, above the tracer's proxy mode:
    each ATen call reaches this mode first, and every node the tracer
    creates for it is mapped to the innermost ``repro_torch`` frame (the
    analysis package excluded) of the Python stack at the call."""

    def __init__(self, sites: Dict):
        from torch.fx.experimental.proxy_tensor import get_proxy_mode
        super().__init__()
        self.sites = sites
        self.proxy_mode = get_proxy_mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        mode = self.proxy_mode()
        graph = mode.tracer.graph if mode is not None else None
        before = len(graph.nodes) if graph is not None else 0
        out = func(*args, **(kwargs or {}))
        if graph is not None and len(graph.nodes) > before:
            site = _innermost_port_frame(sys._getframe(1))
            for node in itertools.islice(reversed(graph.nodes),
                                         len(graph.nodes) - before):
                self.sites[node] = site
        return out


def _innermost_port_frame(frame) -> Optional[Tuple[str, int]]:
    """``(file, line)`` of the innermost frame, from ``frame`` outwards,
    in the port's sources outside this package."""
    while frame is not None:
        name = os.path.abspath(frame.f_code.co_filename)
        if _PORT_DIR in name and _ANALYSIS_DIR not in name:
            return name, frame.f_lineno
        frame = frame.f_back
    return None


def trace_wave(step, state: Dict[str, torch.Tensor]):
    """``(graph module, {node: (file, line)})`` of one call ``step(state)``
    traced by ``make_fx`` in real mode (the ops run on ``state``'s
    device). Raises where ``step`` reads a value back to the host."""
    from torch.fx.experimental.proxy_tensor import make_fx
    sites: Dict = {}

    def run(s):
        with _Sites(sites):
            return step(s)

    gm = make_fx(run, tracing_mode="real")(state)
    return gm, sites


class _Recorder(TorchDispatchMode):
    """Records the ATen calls of one eager run: each operation with each
    argument as its producer (a state key, an earlier call's output, or a
    constant by shape and dtype) or its literal value — the content of the
    FX graph ``make_fx`` builds, without its per-node fake tensors."""

    def __init__(self, state: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = {id(t): ("in", k) for k, t in state.items()}
        self.keep = list(state.values())     # no id() is reused meanwhile
        self.calls: List[str] = []

    def name(self, x):
        if isinstance(x, torch.Tensor):
            return self.names.get(id(x),
                                  ("const", tuple(x.shape), str(x.dtype)))
        return repr(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils import _pytree as pytree
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        i = len(self.calls)
        named = pytree.tree_map(self.name, (args, kwargs))
        self.calls.append(f"{func}{named}")
        for j, t in enumerate(pytree.tree_leaves(out)):
            if isinstance(t, torch.Tensor):
                self.names[id(t)] = ("op", i, j)
                self.keep.append(t)
        return out


def program_hash(step, state: Dict[str, torch.Tensor]) -> str:
    """Hash of the program one call ``step(state)`` runs: its operations,
    their order, their dataflow and every Python value baked into them.
    Two calls hash alike exactly when ``make_fx`` would trace them to the
    same graph; recording them eagerly costs a fraction of tracing."""
    rec = _Recorder(state)
    with rec:
        step(state)
    return hashlib.sha1("\n".join(rec.calls).encode()).hexdigest()[:16]


def op_counts(gm) -> Dict[str, int]:
    """``{ATen operation: count}`` of the traced program, most common
    first."""
    out: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op == "call_function":
            name = _op_name(node)
            out[name] = out.get(name, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))


# ---------------------------------------------------------------- walking

def _op_name(node) -> str:
    packet = getattr(node.target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(
        node.target, "__name__", str(node.target))
    return name[:-1] if name.endswith("_") else name


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _dtype(node) -> Optional[torch.dtype]:
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _is_float(node) -> bool:
    dt = _dtype(node)
    return dt is not None and dt.is_floating_point


class _GraphAuditor:
    """One walk over a traced wave, collecting deduplicated findings."""

    def __init__(self, gm, sites: Dict, root: str, label: str):
        self.gm = gm
        self.sites = sites
        self.root = root
        self.label = label
        self.findings: List[Finding] = []
        self._seen: set = set()

    def site(self, node) -> Tuple[str, int, str]:
        got = self.sites.get(node)
        if got is None:
            return "", 0, ""
        fname, line = got
        rel = os.path.relpath(fname, os.path.abspath(self.root))
        return (rel.replace(os.sep, "/"), line,
                linecache.getline(fname, line).strip())

    def emit(self, rule: str, node, message: str) -> None:
        file, line, snippet = self.site(node) if node is not None \
            else ("", 0, "")
        key = (rule, file, line, message if not file else "")
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            rule=rule, file=file, line=line,
            message=f"{message} [traced via {self.label}]",
            snippet=snippet))

    def constant(self, arg):
        """The value of ``arg`` when it is a constant of the traced
        program (a Python number, or a tensor attribute), else None."""
        if isinstance(arg, (int, float, bool)):
            return torch.tensor(arg)
        if getattr(arg, "op", None) == "get_attr":
            v = getattr(self.gm, arg.target, None)
            return v if isinstance(v, torch.Tensor) else None
        return None

    def producer(self, arg):
        """The node that computes ``arg``, looking through shape
        plumbing."""
        for _ in range(32):
            if getattr(arg, "op", None) != "call_function" or \
                    _op_name(arg) not in TRANSPARENT_OPS:
                return arg
            arg = arg.args[0]
        return arg

    def guarded(self, arg, positive: bool = False) -> bool:
        src = self.producer(arg)
        const = self.constant(src)
        if const is not None:
            bad = (const <= 0) if positive else (const == 0)
            return not bool(bad.any())
        return getattr(src, "op", None) == "call_function" and \
            _op_name(src) in GUARD_OPS

    def walk(self, state: Dict[str, torch.Tensor]) -> None:
        for key, v in sorted(state.items()):
            if isinstance(v, torch.Tensor) and v.dtype == torch.float64:
                self.emit("carry-f64", None,
                          f"wave state {key!r} is {v.dtype} "
                          f"{tuple(v.shape)}: the parity contract is f32 "
                          "op for op")
        for node in self.gm.graph.nodes:
            if node.op == "get_attr":
                const = self.constant(node)
                if const is not None and const.dtype == torch.float64:
                    self.emit("f64-const", node,
                              f"f64 constant {node.target} closed over by "
                              "the traced wave")
            if node.op != "call_function":
                continue
            name = _op_name(node)
            if _dtype(node) == torch.float64:
                self.emit("f64-const", node,
                          f"{name} yields f64 inside the traced wave")
            if not _is_float(node):
                continue
            self.rules(node, name)

    def rules(self, node, name: str) -> None:
        alpha = node.kwargs.get("alpha")
        if name in FMA_OPS or (name in ALPHA_OPS and alpha is not None
                               and alpha not in (1, -1)):
            what = name if name in FMA_OPS else f"{name}(alpha={alpha})"
            self.emit("while-fma", node,
                      f"fused multiply-add {what} inside the wave — one "
                      "kernel that may keep the exact product; write the "
                      "product and the add as two ops")
        elif name in REDUCE_OPS or (
                name in ACCUMULATE_OPS and _arg(node, 3, "accumulate")) or (
                name in SCATTER_REDUCE_OPS
                and _arg(node, 3, "reduce") in ("sum", "mean", "prod")):
            self.emit("loop-reduce", node,
                      f"order-sensitive float {name} inside the wave — "
                      "numpy must reduce in the identical order (pragma "
                      "with the proof) or use min/max")
        elif name == "div":
            if not self.guarded(node.args[1]):
                self.emit("unguarded-div", node,
                          "float division in the wave with an unguarded "
                          "denominator — batched padding rows can mint "
                          "NaN/inf; use repro_torch.core.numerics."
                          "guarded_denominator")
        elif name in LOG_OPS:
            if not self.guarded(node.args[0], positive=True):
                self.emit("unguarded-log", node,
                          f"{name} in the wave with an unclamped operand")


def _arg(node, pos: int, key: str):
    if len(node.args) > pos:
        return node.args[pos]
    return node.kwargs.get(key)


def audit_graph(gm, sites: Dict, state: Dict[str, torch.Tensor], root: str,
                label: str) -> List[Finding]:
    """All trace rules over one traced wave and its input state."""
    auditor = _GraphAuditor(gm, sites, root, label)
    auditor.walk(state)
    return auditor.findings


def audit_step(step, state: Dict[str, torch.Tensor], root: str,
               label: str) -> List[Finding]:
    """Trace ``step(state)`` and audit it (the synthetic-function form the
    tests use)."""
    gm, sites = trace_wave(step, state)
    return audit_graph(gm, sites, state, root, label)


# ------------------------------------------------------------- kernels

def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (``<wrapper>.launches``)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gmm_logpdf import gmm_logpdf
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.queue_scan import fused_admission, queue_scan
    return {k.__name__: k.launches for k in (
        fused_admission, queue_scan, gmm_logpdf, flash_attention,
        mamba2_scan)}


def audit_call(call: CapturedCall, root: str, label: str,
               audited: Iterable[str] = (), **overrides):
    """Trace one wave of a captured ``simulate_ensemble`` call and audit
    it; a kernel launched inside the traced wave whose SASS is not in
    ``audited`` is ``kernel-opaque``. Returns ``(findings, graph
    module)``."""
    prog = call.program(**overrides)
    before = launch_counts()
    gm, sites = trace_wave(prog.wave, prog.state)
    after = launch_counts()
    findings = audit_graph(gm, sites, prog.state, root, label)
    for name in sorted(after):
        if after[name] > before[name] and name not in set(audited):
            findings.append(Finding(
                rule="kernel-opaque", file="", line=0,
                message=(f"{name} launched inside the traced wave "
                         f"({label}) and its SASS was not audited")))
    return findings, gm


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump`` beside its ``nvcc``."""
    from repro_torch.kernels import _build
    return os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")


def sass_fma_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """``{kernel function: {FFMA/DFMA/HFMA2: count}}`` of ``cuobjdump
    -sass`` output (predicated and suffixed forms included)."""
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {op: 0 for op in FMA_OPCODES}
            continue
        if fn is None or "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split(";")[0].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        base = words[0].split(".")[0]
        for op in FMA_OPCODES:
            if base.startswith(op):
                counts[fn][op] += 1
    return counts


def sass_audit(names: Sequence[str] = ENGINE_KERNELS + FLOAT_KERNELS):
    """Build each kernel library in ``names`` and count the FMA
    instructions in its SASS. Returns ``(findings, counts, audited)``:
    ``kernel-fma`` for every engine kernel function with a count above 0,
    ``kernel-opaque`` for an engine library whose SASS could not be read;
    ``counts`` ``{library: {function: {opcode: n}}}`` for every library
    read; ``audited`` the libraries read."""
    from repro_torch.kernels import _build
    findings: List[Finding] = []
    counts: Dict[str, Dict[str, Dict[str, int]]] = {}
    tool = cuobjdump()
    for name in names:
        src = f"src/repro_torch/kernels/csrc/{name}.cu"
        try:
            sass = subprocess.run(
                [tool, "-sass", str(_build.build(name))],
                capture_output=True, text=True, timeout=300,
                check=True).stdout
            counts[name] = sass_fma_counts(sass)
            if not counts[name]:
                raise ValueError("no kernel function in the SASS")
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            counts.pop(name, None)
            if name in ENGINE_KERNELS:
                findings.append(Finding(
                    rule="kernel-opaque", file=src, line=0,
                    message=(f"the SASS of the {name} library could not be "
                             f"read ({type(e).__name__}): the kernel went "
                             "unaudited")))
            continue
        if name not in ENGINE_KERNELS:
            continue
        for fn, c in sorted(counts[name].items()):
            if sum(c.values()):
                findings.append(Finding(
                    rule="kernel-fma", file=src, line=0,
                    message=(f"{fn}: " + ", ".join(
                        f"{n} {op}" for op, n in c.items() if n)
                        + " in the SASS of an exact engine kernel")))
    return findings, counts, set(counts)


def finding_keys(findings: Iterable[Finding],
                 drop: Sequence[str] = CARD_ONLY_RULES) -> set:
    """The findings as a set to compare two devices' runs by: ``(rule,
    file, line, source line)``, or the message without its ``[traced via
    ...]`` label where there is no source site; the rules in ``drop``
    left out."""
    return {(f.rule, f.file, f.line,
             f.snippet or f.message.split(" [traced via ")[0])
            for f in findings if f.rule not in drop}


# ------------------------------------------------------------------ entry

def smoke_calls(device) -> List[Tuple[str, CapturedCall]]:
    """The production calls the pass traces: ``run_experiment`` of the
    smoke spec, and a 2-point trigger sweep of it (both on the
    ``"torch"`` engine)."""
    from repro_torch.core.experiment import Sweep, run_experiment
    out = []
    with capture_calls() as calls:
        run_experiment(smoke_spec(engine="torch"), device=device)
    out += [("simulate_ensemble", c) for c in calls[:1]]
    mini = Sweep(smoke_spec(engine="torch"),
                 {"trigger:drift_threshold": [0.05, 0.2]})
    with capture_calls() as calls:
        mini.run(device=device)
    out += [("simulate_ensemble[sweep]", c) for c in calls[:1]]
    return out


def run_jaxpr_audit(root: str, device=None, calls=None,
                    report=None) -> List[Finding]:
    """Capture, trace and audit the production engine calls (default: the
    smoke spec and a 2-point sweep of it; ``calls`` gives ``(label,
    CapturedCall)`` pairs instead) on ``device`` (``None``: the card).
    On the card the engine kernels' SASS is audited first, and each call
    is traced twice: as captured (``admission_sort="kernel"``, the kernel
    launched inside the trace) and with the plain admission, so the
    admission stage's ops are traced on both devices. ``report(what,
    value)``, when given, receives each traced wave's op counts and the
    SASS counts."""
    dev = resolve_device(device)
    findings: List[Finding] = []
    audited: set = set()
    if dev.type == "cuda":
        fs, counts, audited = sass_audit()
        findings += fs
        if report is not None:
            report("sass", counts)
    for label, call in (calls if calls is not None else smoke_calls(dev)):
        variants = [(label, {})]
        if dev.type == "cuda":
            variants.append((f"{label}[dense]", {"admission_sort": "dense"}))
        for name, over in variants:
            fs, gm = audit_call(call, root, name, audited, **over)
            findings += fs
            if report is not None:
                report(f"ops {name}", op_counts(gm))
    return findings
