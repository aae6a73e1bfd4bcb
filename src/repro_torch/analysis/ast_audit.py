"""AST pass: engine-mirror structure and the port's parity lint rules
(mirrors :mod:`repro.analysis.ast_audit`).

Pure-``ast`` analysis over the port's engine/ops/obs sources and, read as
text, the reference's ``core/des.py``, ``core/vdes.py`` and
``core/metrics.py`` (no imports, no execution: this pass runs where JAX is
not installed, and even when the engine under audit is broken):

- **mirror-missing / mirror-stale** — every wave stage nested in the
  port's ``simulate_ensemble`` or its builder ``wave_program``
  (``_select_events`` and the ``_*_stage`` functions) must have a
  ``# mirror: vdes.<stage>`` marker in the port's ``des.py`` (the numpy
  heap engine the batched engine is held against), every marker must
  name a port stage, and the port's stage set must equal the reference
  ``vdes.simulate``'s;
- **layout-redef** — the layout constants (``CTRL_*``, ``TRIG_*``,
  ``PROBE_*``, ``FLEET_*``) are owned by ``repro_torch/core/des.py`` /
  ``core/metrics.py``; a redefinition anywhere else, or an owner's value
  that differs from the reference owner's, means the engines can silently
  disagree on a tensor layout;
- **layout-index** — no hard-coded integer field index into a layout
  tensor (names rooted in trig/probe/ctrl/hdr/header/fleet), nor a
  ``name[i] for i in range(<literal>)`` unpack;
- **engine-fma** — no fused multiply-add *operation* in an engine file:
  ``addcmul``, ``addcdiv``, ``lerp``, ``addmm``, ``addmv``, ``addbmm``,
  ``baddbmm`` (in-place forms included), and ``add``/``sub`` with an
  ``alpha=`` other than the literal ±1. Each is one ATen kernel that nvcc
  may compile to an FMA. A bare ``a - b*c`` is not flagged: in eager torch
  it is two kernels, each rounding (:mod:`repro_torch.core.numerics`);
- **hot-f64** — no ``torch.float64`` / ``torch.double`` / ``.double()`` /
  ``np.float64`` in the engine's functions (host-side helpers
  ``simulate_to_trace`` and ``gain_order_bound`` are exempt). A Python
  ``float(...)`` is not flagged: a wrapped scalar does not promote an f32
  tensor;
- **mutable-default** — no mutable default arguments anywhere in the port;
- **probe-reduce** — no sum/mean-class reductions in probe-channel code
  (``_probe_stage`` / ``obs/probes.py``). (The dtype-aware trace pass owns
  the wave body's reductions: integer count sums are order-exact.)
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, bad_pragma_findings

# engine stage files: the f32 parity-mirrored arithmetic lives here
ENGINE_FILES = (
    "src/repro_torch/core/des.py",
    "src/repro_torch/core/vdes.py",
    "src/repro_torch/core/metrics.py",
    "src/repro_torch/obs/probes.py",
)
# files that consume/compile the flat layout tensors
LAYOUT_FILES = ENGINE_FILES + (
    "src/repro_torch/core/batching.py",
    "src/repro_torch/ops/scenario.py",
    "src/repro_torch/ops/capacity.py",
)
# single source of truth for the port's layout constants, and the
# reference's owners their values are held against
LAYOUT_OWNERS = ("src/repro_torch/core/des.py",
                 "src/repro_torch/core/metrics.py")
REF_LAYOUT_OWNERS = ("src/repro/core/des.py", "src/repro/core/metrics.py")

VDES_FILE = "src/repro_torch/core/vdes.py"
PROBES_FILE = "src/repro_torch/obs/probes.py"
# the port's heap engine (its mirror markers) and the reference's batched
# engine, whose stage set the port's is held against
DES_FILE = "src/repro_torch/core/des.py"
REF_VDES_FILE = "src/repro/core/vdes.py"

# the functions whose nested stages make up the wave loop
LOOP_FUNCS = ("simulate_ensemble", "wave_program")

_LAYOUT_NAME_RE = re.compile(r"^(CTRL|TRIG|PROBE|FLEET)_[A-Z]")
_HEADER_TOKEN_RE = re.compile(r"^(trig|probe|ctrl|hdr|header|fleet)")
_STAGE_NAME_RE = re.compile(r"^_select_events$|^_\w+_stage$")
_MIRROR_MARKER_RE = re.compile(r"#\s*mirror:\s*vdes\.(\w+)")

_SUM_CLASS = {"sum", "nansum", "mean", "nanmean", "average", "prod",
              "cumsum", "dot"}
_FMA_CALLS = {"addcmul", "addcdiv", "lerp", "addmm", "addmv", "addbmm",
              "baddbmm"}
_ALPHA_CALLS = {"add", "sub", "subtract"}
_F64_ATTRS = ("float64", "double", "float_")
_HOT_F64_EXEMPT = {"simulate_to_trace", "gain_order_bound"}


def _snippet(lines: Sequence[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


def _walk_files(root: str) -> List[str]:
    """Every .py under src/repro_torch (repo-relative posix paths),
    sorted."""
    base = os.path.join(root, "src", "repro_torch")
    out = []
    for dirpath, _, names in os.walk(base):
        for name in names:
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                out.append(os.path.relpath(full, root).replace(os.sep, "/"))
    return sorted(out)


def _parse(root: str, rel: str) -> Optional[Tuple[ast.AST, List[str]]]:
    full = os.path.join(root, rel)
    if not os.path.exists(full):
        return None
    with open(full) as fh:
        src = fh.read()
    return ast.parse(src, filename=rel), src.splitlines()


# ----------------------------------------------------------- mirror rules

def stage_defs(tree: ast.AST, outer=LOOP_FUNCS) -> Dict[str, int]:
    """``{stage name: lineno}`` of the wave stages nested in the functions
    named ``outer`` (the port's loop functions; ``("simulate",)`` for the
    reference's ``vdes``)."""
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in outer:
            for sub in ast.walk(node):
                if isinstance(sub, ast.FunctionDef) and \
                        _STAGE_NAME_RE.match(sub.name):
                    out.setdefault(sub.name, sub.lineno)
    return out


def mirror_markers(lines: Sequence[str]) -> Dict[str, int]:
    """``{stage name: lineno}`` of ``# mirror: vdes.<stage>`` markers."""
    out: Dict[str, int] = {}
    for i, text in enumerate(lines, start=1):
        m = _MIRROR_MARKER_RE.search(text)
        if m:
            out.setdefault(m.group(1), i)
    return out


def check_mirrors(vdes_tree: ast.AST, vdes_lines: Sequence[str],
                  des_lines: Sequence[str],
                  ref_vdes: Optional[Tuple[ast.AST, List[str]]] = None
                  ) -> List[Finding]:
    """The port's stages against its heap engine's markers, and (when the
    reference's ``vdes.py`` is there) against the reference's stages."""
    stages = stage_defs(vdes_tree)
    markers = mirror_markers(des_lines)
    out = []
    for name, lineno in sorted(stages.items(), key=lambda kv: kv[1]):
        if name not in markers:
            out.append(Finding(
                rule="mirror-missing", file=VDES_FILE, line=lineno,
                message=(f"wave stage {name} has no "
                         f"'# mirror: vdes.{name}' marker in the port's "
                         "des.py — the numpy mirror is missing or "
                         "unlabelled"),
                snippet=_snippet(vdes_lines, lineno)))
    for name, lineno in sorted(markers.items(), key=lambda kv: kv[1]):
        if name not in stages:
            out.append(Finding(
                rule="mirror-stale", file=DES_FILE, line=lineno,
                message=(f"mirror marker points at vdes.{name}, which is "
                         "not a wave stage of the port"),
                snippet=_snippet(des_lines, lineno)))
    if ref_vdes is not None:
        ref_tree, ref_lines = ref_vdes
        ref = stage_defs(ref_tree, outer=("simulate",))
        for name, lineno in sorted(ref.items(), key=lambda kv: kv[1]):
            if name not in stages:
                out.append(Finding(
                    rule="mirror-missing", file=REF_VDES_FILE, line=lineno,
                    message=(f"the reference's stage {name} has no "
                             "counterpart in the port's wave loop"),
                    snippet=_snippet(ref_lines, lineno)))
        for name, lineno in sorted(stages.items(), key=lambda kv: kv[1]):
            if name not in ref:
                out.append(Finding(
                    rule="mirror-stale", file=VDES_FILE, line=lineno,
                    message=(f"wave stage {name} has no counterpart in the "
                             "reference's vdes.simulate"),
                    snippet=_snippet(vdes_lines, lineno)))
    return out


# ------------------------------------------------------------ lint rules

def _is_unit(node: ast.AST) -> bool:
    """The literal 1 or -1 (int or float)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and type(node.value) in (
        int, float) and node.value == 1


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def engine_fma(rel: str, tree: ast.AST, lines: Sequence[str]) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        base = name[:-1] if name.endswith("_") else name
        alpha = next((kw.value for kw in node.keywords if kw.arg == "alpha"),
                     None)
        if base in _FMA_CALLS:
            what = f"{name}()"
        elif base in _ALPHA_CALLS and alpha is not None and \
                not _is_unit(alpha):
            what = f"{name}(..., alpha={ast.unparse(alpha)})"
        else:
            continue
        out.append(Finding(
            rule="engine-fma", file=rel, line=node.lineno,
            message=(f"fused multiply-add {what} in an engine file: one "
                     "ATen kernel that may keep the exact product (numpy "
                     "rounds it first) — write the product and the add as "
                     "two ops"),
            snippet=_snippet(lines, node.lineno)))
    return out


def _header_tokens(node: ast.AST) -> List[str]:
    toks = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            toks.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            toks.append(sub.attr)
    return toks


def _is_int_const(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and type(node.value) is int)


def _index_has_literal(idx: ast.AST) -> bool:
    if _is_int_const(idx):
        return True
    if isinstance(idx, ast.Slice):
        return any(part is not None and _is_int_const(part)
                   for part in (idx.lower, idx.upper, idx.step))
    if isinstance(idx, ast.Tuple):
        return any(_index_has_literal(el) for el in idx.elts)
    return False


def layout_index(rel: str, tree: ast.AST,
                 lines: Sequence[str]) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript):
            # shape tuples are positional by nature, not layout fields
            if isinstance(node.value, ast.Attribute) and \
                    node.value.attr == "shape":
                continue
            if not any(_HEADER_TOKEN_RE.match(t)
                       for t in _header_tokens(node.value)):
                continue
            if _index_has_literal(node.slice):
                out.append(Finding(
                    rule="layout-index", file=rel, line=node.lineno,
                    message=("hard-coded field index into a layout tensor — "
                             "use the named header constants from "
                             "repro_torch.core.des / repro_torch.core."
                             "metrics"),
                    snippet=_snippet(lines, node.lineno)))
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            # `name[i] for i in range(<literal>)`: a positional unpack whose
            # width is a magic number
            subscripts_header = any(
                isinstance(sub, ast.Subscript)
                and any(_HEADER_TOKEN_RE.match(t)
                        for t in _header_tokens(sub.value))
                for sub in ast.walk(node.elt))
            literal_range = any(
                isinstance(gen.iter, ast.Call)
                and isinstance(gen.iter.func, ast.Name)
                and gen.iter.func.id == "range"
                and any(_is_int_const(a) for a in gen.iter.args)
                for gen in node.generators)
            if subscripts_header and literal_range:
                out.append(Finding(
                    rule="layout-index", file=rel, line=node.lineno,
                    message=("layout-tensor unpack over a literal range() — "
                             "use the named field count/constants"),
                    snippet=_snippet(lines, node.lineno)))
    return out


def _assign(node: ast.AST):
    """``(target names, value, is an unpack)`` of an assignment node (a
    target that is not a plain name is None), else None."""
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets = [node.target]
    else:
        return None
    names, unpack = [], False
    for tgt in targets:
        unpack = unpack or isinstance(tgt, ast.Tuple)
        elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
        names += [el.id if isinstance(el, ast.Name) else None for el in elts]
    return names, node.value, unpack


def layout_redef(rel: str, tree: ast.AST,
                 lines: Sequence[str]) -> List[Finding]:
    if rel in LAYOUT_OWNERS:
        return []
    out = []
    for node in ast.walk(tree):
        got = _assign(node)
        for name in got[0] if got else ():
            if name is not None and _LAYOUT_NAME_RE.match(name):
                out.append(Finding(
                    rule="layout-redef", file=rel, line=node.lineno,
                    message=(f"layout constant {name} redefined — import "
                             "it from repro_torch.core.des / repro_torch."
                             "core.metrics instead"),
                    snippet=_snippet(lines, node.lineno)))
    return out


_BINOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.FloorDiv: lambda a, b: a // b,
           ast.LShift: lambda a, b: a << b}


def _const_value(node: ast.AST, env: Dict[str, object]):
    """The value of a module-level constant expression: literals, names
    bound earlier in the module, + - * // <<, unary minus, tuples,
    ``range(...)`` and numeric casts (``np.float32(x)``, ``float``,
    ``int``). Raises ``ValueError`` on anything else."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise ValueError(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_const_value(node.operand, env)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_const_value(node.left, env),
                                      _const_value(node.right, env))
    if isinstance(node, ast.Tuple):
        return tuple(_const_value(el, env) for el in node.elts)
    if isinstance(node, ast.Call) and not node.keywords:
        name = _call_name(node)
        args = [_const_value(a, env) for a in node.args]
        if name == "range":
            return tuple(range(*args))
        if name in ("float", "float32", "float64") and len(args) == 1:
            # compared in the f32 the layout tensors carry
            import numpy as np
            return float(np.float32(args[0]))
        if name == "int" and len(args) == 1:
            return int(args[0])
    raise ValueError(ast.dump(node))


def layout_values(tree: ast.AST) -> Dict[str, Tuple[object, int]]:
    """``{layout constant: (value, lineno)}`` of a module's top-level
    assignments (a value that does not evaluate is kept as its source
    text)."""
    env: Dict[str, object] = {}
    out: Dict[str, Tuple[object, int]] = {}
    for node in getattr(tree, "body", []):
        got = _assign(node)
        if got is None:
            continue
        names, value, unpack = got
        try:
            val = _const_value(value, env)
            vals = list(val) if unpack else [val] * len(names)
        except (ValueError, TypeError, ZeroDivisionError):
            vals = []
        if len(vals) != len(names):
            vals = [ast.unparse(value)] * len(names)
        for name, v in zip(names, vals):
            if name is None:
                continue
            env[name] = v
            if _LAYOUT_NAME_RE.match(name):
                out[name] = (v, node.lineno)
    return out


def layout_values_differ(parsed: Dict[str, Tuple[ast.AST, List[str]]],
                         ref: Dict[str, Tuple[ast.AST, List[str]]]
                         ) -> List[Finding]:
    """``layout-redef`` findings for constants of the port's owners whose
    value differs from the same constant's in the reference's owners."""
    ref_vals: Dict[str, object] = {}
    for rel in REF_LAYOUT_OWNERS:
        if rel in ref:
            ref_vals.update({k: v for k, (v, _) in
                             layout_values(ref[rel][0]).items()})
    out = []
    for rel in LAYOUT_OWNERS:
        if rel not in parsed:
            continue
        tree, lines = parsed[rel]
        for name, (val, lineno) in sorted(layout_values(tree).items()):
            if name in ref_vals and ref_vals[name] != val:
                out.append(Finding(
                    rule="layout-redef", file=rel, line=lineno,
                    message=(f"layout constant {name} = {val!r} differs "
                             f"from the reference's {ref_vals[name]!r}: "
                             "the engines would disagree on a tensor "
                             "layout"),
                    snippet=_snippet(lines, lineno)))
    return out


def _top_functions(tree: ast.AST):
    """Module-level functions and methods (nested functions are walked
    with their enclosing one, so each site is reported once)."""
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.FunctionDef):
            yield node
        elif isinstance(node, ast.ClassDef):
            yield from (n for n in node.body
                        if isinstance(n, ast.FunctionDef))


def hot_f64(rel: str, tree: ast.AST, lines: Sequence[str]) -> List[Finding]:
    out = []
    for fn in _top_functions(tree):
        if fn.name in _HOT_F64_EXEMPT:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and node.attr in _F64_ATTRS:
                out.append(Finding(
                    rule="hot-f64", file=rel, line=node.lineno,
                    message=(f"{node.attr} in the wave loop's code promotes "
                             "f32 parity state to f64"),
                    snippet=_snippet(lines, node.lineno)))
    return out


def mutable_default(rel: str, tree: ast.AST,
                    lines: Sequence[str]) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for default in list(fn.args.defaults) + \
                [d for d in fn.args.kw_defaults if d is not None]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set"))
            if mutable:
                out.append(Finding(
                    rule="mutable-default", file=rel, line=fn.lineno,
                    message=(f"mutable default argument on {fn.name}() — "
                             "shared across calls; default to None"),
                    snippet=_snippet(lines, fn.lineno)))
    return out


def probe_reduce(rel: str, tree: ast.AST, lines: Sequence[str],
                 scope: Optional[ast.AST] = None) -> List[Finding]:
    out = []
    for node in ast.walk(scope if scope is not None else tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SUM_CLASS:
            out.append(Finding(
                rule="probe-reduce", file=rel, line=node.lineno,
                message=(f"order-dependent {node.func.attr}() in a probe "
                         "channel — the batched and numpy reduction orders "
                         "differ; probe channels must use min/max"),
                snippet=_snippet(lines, node.lineno)))
    return out


def _probe_stage_scope(vdes_tree: ast.AST) -> Optional[ast.AST]:
    for node in ast.walk(vdes_tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_probe_stage":
            return node
    return None


# ----------------------------------------------------------------- entry

def audit_tree(root: str) -> List[Finding]:
    """Run every AST rule over the port at ``root``. Findings come back
    un-suppressed — pragma/baseline filtering happens in the driver."""
    parsed: Dict[str, Tuple[ast.AST, List[str]]] = {}
    for rel in set(_walk_files(root)) | set(LAYOUT_FILES):
        got = _parse(root, rel)
        if got is not None:
            parsed[rel] = got
    ref: Dict[str, Tuple[ast.AST, List[str]]] = {}
    for rel in {REF_VDES_FILE, *REF_LAYOUT_OWNERS}:
        got = _parse(root, rel)
        if got is not None:
            ref[rel] = got

    findings: List[Finding] = []

    if VDES_FILE in parsed and DES_FILE in parsed:
        vdes_tree, vdes_lines = parsed[VDES_FILE]
        findings += check_mirrors(vdes_tree, vdes_lines, parsed[DES_FILE][1],
                                  ref.get(REF_VDES_FILE))

    for rel in ENGINE_FILES:
        if rel in parsed:
            findings += engine_fma(rel, *parsed[rel])
    for rel in LAYOUT_FILES:
        if rel in parsed:
            findings += layout_index(rel, *parsed[rel])
            findings += layout_redef(rel, *parsed[rel])
    findings += layout_values_differ(parsed, ref)
    if VDES_FILE in parsed:
        tree, lines = parsed[VDES_FILE]
        findings += hot_f64(VDES_FILE, tree, lines)
        scope = _probe_stage_scope(tree)
        if scope is not None:
            findings += probe_reduce(VDES_FILE, tree, lines, scope=scope)
    if PROBES_FILE in parsed:
        findings += probe_reduce(PROBES_FILE, *parsed[PROBES_FILE])
    for rel, (tree, lines) in sorted(parsed.items()):
        findings += mutable_default(rel, tree, lines)
        findings += bad_pragma_findings(rel, lines)
    return findings
