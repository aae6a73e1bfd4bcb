"""OTel-style span export: simulation traces as distributed-tracing trees
(mirrors :mod:`repro.obs.spans`; plain numpy and ``json``).

Converts a run's :class:`~repro_torch.core.trace.TaskRecords` (per-task
and, under failure/retry scenarios, per-attempt ``att_start``/``att_finish``
intervals) plus the engine-recorded
:meth:`~repro_torch.core.model.SimTrace.action_timeline` into the span tree
a trace viewer expects::

    run                               (root span, one per export)
    +- pipeline 17                    (arrival .. last task finish)
    |  +- task 0 (train)              (start .. finish)
    |  |  +- attempt 0                (att_start .. att_finish)
    |  |  +- attempt 1
    |  +- task 1 (evaluate)
    ...

Controller scale actions and lifecycle trigger/redeploy actions attach to
the root span as zero-duration *span events* (OTel semantics; ``ph: "i"``
instants in the Chrome export). Latent retraining-pool rows whose trigger
never fired are invisible by construction: spans are built from
:func:`~repro_torch.core.trace.flatten_trace` records, which drop them.

Two writers:

  - :func:`write_spans_jsonl` — one span per line, OTel-field naming
    (``trace_id``/``span_id``/``parent_span_id``, times as exact f64
    seconds). Python's ``json`` round-trips f64 via ``repr``, so
    :func:`read_spans_jsonl` reconstructs every interval *bit-exactly* —
    the round-trip test diffs against ``TaskRecords`` with ``==``.
  - :func:`write_chrome_trace` — Chrome/Perfetto ``trace_event`` JSON
    (``chrome://tracing`` or https://ui.perfetto.dev). ``ts``/``dur`` are
    microseconds (the format's unit); the exact second timestamps ride in
    ``args.t0_s``/``args.t1_s`` so tooling can recover the unquantized
    intervals.

Span ids are deterministic functions of (kind, pipeline, task, attempt) —
two exports of the same run are byte-identical, and tests can address spans
without parsing names.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import model as M
from repro_torch.core.trace import TaskRecords

# span kinds (high byte of the deterministic span id)
_K_RUN, _K_PIPELINE, _K_TASK, _K_ATTEMPT = 0, 1, 2, 3


def _span_id(kind: int, pipeline: int = 0, pos: int = 0,
             attempt: int = 0) -> str:
    """Deterministic 16-hex span id: kind | pipeline | task pos | attempt."""
    return f"{(kind << 56) | (pipeline << 16) | (pos << 8) | attempt:016x}"


def _task_name(t: int) -> str:
    return M.TASK_TYPE_NAMES[t] if 0 <= t < len(M.TASK_TYPE_NAMES) \
        else f"type{t}"


def _res_name(r: int) -> str:
    return M.RESOURCE_NAMES[r] if 0 <= r < len(M.RESOURCE_NAMES) \
        else f"res{r}"


def build_spans(rec: TaskRecords, tr: Optional[M.SimTrace] = None,
                name: str = "run") -> List[dict]:
    """Build the flat span list (each span: ``trace_id`` / ``span_id`` /
    ``parent_span_id`` / ``name`` / ``kind`` / ``start_s`` / ``end_s`` /
    ``attributes``, root also ``events``) for one run's records.

    ``tr`` (the run's :class:`~repro_torch.core.model.SimTrace`) contributes the
    in-engine action timeline as root-span events. Tasks stranded mid-retry
    (NaN start/finish) export with ``null`` times and
    ``attributes.stranded`` — a viewer skips them, accounting can still
    count them."""
    trace_id = f"{abs(hash(name)) & (2 ** 64 - 1):016x}"
    start = np.asarray(rec.start, np.float64)
    finish = np.asarray(rec.finish, np.float64)
    arrival = np.asarray(rec.arrival, np.float64)

    def _t(x: float):
        return None if np.isnan(x) else float(x)

    t_lo = float(np.nanmin(arrival)) if arrival.size else 0.0
    t_hi = float(np.nanmax(finish)) if finish.size else 0.0
    root = {
        "trace_id": trace_id, "span_id": _span_id(_K_RUN),
        "parent_span_id": None, "name": name, "kind": "run",
        "start_s": min(t_lo, 0.0), "end_s": t_hi,
        "attributes": {"n_tasks": int(start.shape[0]),
                       "n_pipelines": int(np.unique(rec.pipeline).shape[0])},
        "events": [],
    }
    if tr is not None:
        for act, t, payload in tr.action_timeline():
            root["events"].append({
                "name": act, "t_s": float(t),
                "attributes": {"target": np.asarray(payload).tolist()}
                if act == "scale" else {"model": int(payload)},
            })
    spans = [root]

    for pid in np.unique(rec.pipeline):
        m = np.nonzero(rec.pipeline == pid)[0]
        p_id = _span_id(_K_PIPELINE, int(pid))
        p_end = finish[m]
        spans.append({
            "trace_id": trace_id, "span_id": p_id,
            "parent_span_id": root["span_id"],
            "name": f"pipeline:{int(pid)}", "kind": "pipeline",
            "start_s": float(arrival[m[0]]),
            "end_s": _t(np.max(p_end) if not np.isnan(p_end).any()
                        else np.nan),
            "attributes": {
                "pipeline": int(pid), "n_tasks": int(m.shape[0]),
                "done": bool(np.asarray(rec.pipeline_done)[m[0]]),
            },
        })
        for i in m:
            pos = int(rec.task_pos[i])
            t_id = _span_id(_K_TASK, int(pid), pos)
            stranded = bool(np.isnan(start[i]))
            spans.append({
                "trace_id": trace_id, "span_id": t_id,
                "parent_span_id": p_id,
                "name": f"task:{_task_name(int(rec.task_type[i]))}",
                "kind": "task",
                "start_s": _t(start[i]), "end_s": _t(finish[i]),
                "attributes": {
                    "pipeline": int(pid), "task_pos": pos,
                    "resource": _res_name(int(rec.resource[i])),
                    "ready_s": _t(float(rec.ready[i])),
                    "attempts": int(np.asarray(rec.attempts)[i]),
                    **({"stranded": True} if stranded else {}),
                },
            })
            if rec.att_start is None:
                continue
            a_s = np.asarray(rec.att_start, np.float64)[i]
            a_f = np.asarray(rec.att_finish, np.float64)[i]
            for a in np.nonzero(~np.isnan(a_s))[0]:
                spans.append({
                    "trace_id": trace_id,
                    "span_id": _span_id(_K_ATTEMPT, int(pid), pos, int(a)),
                    "parent_span_id": t_id,
                    "name": f"attempt:{int(a)}", "kind": "attempt",
                    "start_s": float(a_s[a]), "end_s": _t(a_f[a]),
                    "attributes": {"pipeline": int(pid), "task_pos": pos,
                                   "attempt": int(a)},
                })
    return spans


def attempt_intervals(spans: List[dict]
                      ) -> Dict[Tuple[int, int, int], Tuple[float, float]]:
    """``{(pipeline, task_pos, attempt): (start_s, end_s)}`` for every
    attempt span — the round-trip test's comparison key. For runs without
    per-attempt records, task spans stand in as attempt 0."""
    out = {}
    have_attempts = any(s["kind"] == "attempt" for s in spans)
    for s in spans:
        a = s["attributes"]
        if have_attempts and s["kind"] == "attempt":
            out[(a["pipeline"], a["task_pos"], a["attempt"])] = \
                (s["start_s"], s["end_s"])
        elif not have_attempts and s["kind"] == "task":
            out[(a["pipeline"], a["task_pos"], 0)] = \
                (s["start_s"], s["end_s"])
    return out


def attempt_intervals_from_records(rec: TaskRecords
                                   ) -> Dict[Tuple[int, int, int],
                                             Tuple[float, float]]:
    """The same mapping straight from :class:`TaskRecords` — ground truth
    for the export round-trip (NaN-started rows excluded, exactly like the
    export skips them)."""
    out = {}
    if rec.att_start is not None:
        a_s = np.asarray(rec.att_start, np.float64)
        a_f = np.asarray(rec.att_finish, np.float64)
        for i in range(a_s.shape[0]):
            for a in np.nonzero(~np.isnan(a_s[i]))[0]:
                out[(int(rec.pipeline[i]), int(rec.task_pos[i]), int(a))] = \
                    (float(a_s[i, a]),
                     None if np.isnan(a_f[i, a]) else float(a_f[i, a]))
    else:
        for i in np.nonzero(~np.isnan(rec.start))[0]:
            out[(int(rec.pipeline[i]), int(rec.task_pos[i]), 0)] = \
                (float(rec.start[i]),
                 None if np.isnan(rec.finish[i]) else float(rec.finish[i]))
    return out


# ---------------------------------------------------------------------------
# writers / readers
# ---------------------------------------------------------------------------

def write_spans_jsonl(spans: List[dict], path: str,
                      append: bool = False) -> None:
    """One span per line. f64 seconds serialize via ``repr`` (shortest
    round-trip representation), so a parse reconstructs every timestamp
    bit-exactly.

    ``append=True`` extends an existing file in place (chunked export: the
    streaming driver writes each window's retired spans as it goes, never
    rewriting earlier chunks). JSONL is concatenation-closed, so N appended
    chunks read back exactly as one list — the round-trip stays bit-exact
    and byte-identical to a single ``append=False`` write of the
    concatenated span list."""
    with open(path, "a" if append else "w") as f:
        for s in spans:
            f.write(json.dumps(s, separators=(",", ":")) + "\n")


def read_spans_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_chrome_trace(spans: List[dict], path: str,
                       events: Optional[List[dict]] = None) -> None:
    """Chrome/Perfetto ``trace_event`` JSON: attempt (or, without
    per-attempt records, task) spans become ``ph: "X"`` complete events on
    one row per pipeline; in-engine actions become ``ph: "i"`` instants.
    ``ts``/``dur`` are integer-quantized microseconds per the format; the
    exact f64 seconds ride in ``args`` (``t0_s``/``t1_s``), which is what
    :func:`read_chrome_attempt_intervals` — and the acceptance gate —
    compare against :class:`TaskRecords`."""
    tes = []
    have_attempts = any(s["kind"] == "attempt" for s in spans)
    leaf = "attempt" if have_attempts else "task"
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        if s["kind"] != leaf or s["start_s"] is None:
            continue
        a = s["attributes"]
        parent = by_id.get(s["parent_span_id"], {})
        label = parent.get("name", s["name"]) if have_attempts else s["name"]
        end = s["end_s"] if s["end_s"] is not None else s["start_s"]
        tes.append({
            "name": f"{label}/{s['name']}" if have_attempts else label,
            "cat": s["kind"], "ph": "X",
            "ts": round(s["start_s"] * 1e6),
            "dur": round((end - s["start_s"]) * 1e6),
            "pid": a["pipeline"], "tid": a["task_pos"],
            "args": {"t0_s": s["start_s"], "t1_s": s["end_s"],
                     "pipeline": a["pipeline"], "task_pos": a["task_pos"],
                     "attempt": a.get("attempt", 0)},
        })
    root = next((s for s in spans if s["kind"] == "run"), None)
    for ev in (events if events is not None
               else (root or {}).get("events", [])):
        tes.append({
            "name": ev["name"], "cat": "action", "ph": "i", "s": "g",
            "ts": round(ev["t_s"] * 1e6), "pid": 0, "tid": 0,
            "args": {"t_s": ev["t_s"], **ev.get("attributes", {})},
        })
    with open(path, "w") as f:
        json.dump({"traceEvents": tes, "displayTimeUnit": "ms"}, f)


def read_chrome_attempt_intervals(path: str
                                  ) -> Dict[Tuple[int, int, int],
                                            Tuple[float, float]]:
    """Recover the exact attempt intervals from a Chrome-trace export (the
    ``args.t0_s``/``t1_s`` payloads — bit-exact, unlike the µs-quantized
    ``ts``/``dur``)."""
    with open(path) as f:
        doc = json.load(f)
    out = {}
    for te in doc["traceEvents"]:
        if te["ph"] != "X":
            continue
        a = te["args"]
        out[(a["pipeline"], a["task_pos"], a["attempt"])] = \
            (a["t0_s"], a["t1_s"])
    return out
