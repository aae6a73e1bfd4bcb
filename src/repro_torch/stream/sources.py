"""Trace sources: where a task stream comes from (mirrors
:mod:`repro.stream.sources`).

The simulator's historical entry point materializes ONE fixed-horizon
workload tensor up front. A :class:`TraceSource` instead yields the
workload in arrival-ordered *blocks* of bounded size, so the streaming
driver (:mod:`repro_torch.stream.driver`) can ingest, simulate and retire tasks
window by window with bounded memory — the trace-driven operating mode the
paper's platform runs in (production analytics traces, not a horizon).

Three sources ship:

  - :class:`SyntheticSource` — wraps :func:`repro_torch.core.synthesizer.
    synthesize_block` with a generator of its own per block and an
    arrival-clock carry, so streamed synthesis is *bit-identical* to
    materializing every block at once (the streamed-vs-oneshot parity gate
    rests on this);
  - :class:`SpanSource` — ingests the OTel-style JSONL span export
    (:mod:`repro_torch.obs.spans`) back into a workload plus a replay
    :class:`~repro_torch.ops.scenario.CompiledScenario`, so yesterday's export
    re-simulates under a different scheduler/controller (replay-what-if);
  - :class:`WorkloadManager` — the pull-driven ingestion buffer between a
    source and the driver (the "constantly running workload generator" of
    the reference implementations, pull-based so the consumer paces it):
    it pulls blocks on demand, keeps per-row columns, and serves exact
    arrival-windowed slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Protocol, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.workload import MAX_TASKS


@runtime_checkable
class TraceSource(Protocol):
    """A re-iterable stream of arrival-ordered workload blocks.

    ``blocks()`` must return a FRESH iterator each call (so a parity
    reference can re-read the same stream), arrivals must be globally
    non-decreasing across the concatenated blocks, and every block must
    share ``max_tasks``. Unbounded sources simply never stop yielding —
    the consumer bounds them (window budget / ``max_blocks``)."""

    name: str

    def blocks(self) -> Iterator[M.Workload]: ...


# ---------------------------------------------------------------------------
# synthetic stream
# ---------------------------------------------------------------------------

def block_seed(seed: int, block_idx: int) -> int:
    """The seed of block ``block_idx``'s generator: a 64-bit word of
    numpy's ``SeedSequence([seed, block_idx])``, so distinct blocks (and
    sources) draw from unrelated streams."""
    return int(np.random.SeedSequence([int(seed), int(block_idx)])
               .generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class SyntheticSource:
    """Unbounded (or bounded) stream of synthesized workload blocks.

    Block ``b`` draws from its own ``torch.Generator`` on ``device`` seeded
    :func:`block_seed` ``(seed, b)`` (where the reference folds ``b`` into
    ``PRNGKey(seed)``) and continues the clustered interarrival clock from
    the previous block's last arrival. Draw shapes depend only on
    ``block_size``, never on any horizon, so the content of block ``b`` is
    a function of ``(params, seed, block_size, b, t0_b)`` and the device
    alone — two consumers reading the same source see identical tensors
    however they window them. The draws are the port's, not JAX's.

    ``n_blocks=None`` and ``until_s=None`` together make the source
    unbounded; ``until_s`` stops yielding once a block *starts* at or past
    that clock (the block that crosses it is still yielded whole).
    ``device`` (``None``: the card) is where the draws run; ``params`` are
    carried there.
    """

    params: object
    platform: Optional[M.PlatformConfig] = None
    seed: int = 0
    block_size: int = 256
    n_blocks: Optional[int] = None
    until_s: Optional[float] = None
    interarrival_factor: float = 1.0
    name: str = "synthetic"
    device: object = None

    def blocks(self) -> Iterator[M.Workload]:
        from repro_torch.core.synthesizer import synthesize_block
        from repro_torch.device import resolve_device
        dev = resolve_device(self.device)
        platform = self.platform or M.PlatformConfig()
        params = self.params.to(dev)
        t0, b = 0.0, 0
        while self.n_blocks is None or b < self.n_blocks:
            if self.until_s is not None and t0 >= self.until_s:
                return
            gen = torch.Generator(dev).manual_seed(block_seed(self.seed, b))
            wl = synthesize_block(params, gen, self.block_size, t0=t0,
                                  platform=platform,
                                  interarrival_factor=self.interarrival_factor)
            t0 = float(wl.arrival[-1])
            b += 1
            yield wl


def materialize(source: TraceSource,
                max_blocks: Optional[int] = None) -> M.Workload:
    """Concatenate a (bounded) source into one plain workload — how the
    non-streaming engines run a ``source``-driven spec, and the workload
    half of the streamed-vs-oneshot parity reference. Unbounded sources
    must pass ``max_blocks``."""
    from repro_torch.core.runtime import _concat_workloads
    out = None
    for b, wl in enumerate(source.blocks()):
        if max_blocks is not None and b >= max_blocks:
            break
        out = wl if out is None else _concat_workloads(out, wl)
    if out is None:
        raise ValueError(f"source {source.name!r} yielded no blocks")
    return out


# ---------------------------------------------------------------------------
# ingestion buffer
# ---------------------------------------------------------------------------

class WorkloadManager:
    """Pull-driven ingestion buffer between a :class:`TraceSource` and the
    streaming driver.

    ``on_block(wl, block_idx) -> dict of [n, ...] arrays`` turns each
    pulled block into per-row columns (the stream driver's hook compiles
    the block's failure draws here, so attempt tensors ride the rows and
    any later windowing slices them consistently); the default just
    exposes the raw workload columns. ``take_until(t)`` returns every
    buffered or pullable row whose **float32** arrival is <= ``t`` — the
    same cast the engine clock uses, so a window boundary can never split
    the stream driver's view from the engine's.
    """

    def __init__(self, source: TraceSource,
                 on_block: Optional[Callable[[M.Workload, int],
                                             Dict[str, np.ndarray]]] = None):
        self._it = source.blocks()
        self._on_block = on_block or _raw_columns
        self._pending: List[Dict[str, np.ndarray]] = []
        self._exhausted = False
        self.n_blocks = 0
        self.n_rows = 0

    @property
    def exhausted(self) -> bool:
        """True once the source stopped AND the buffer drained."""
        return self._exhausted and not self._pending

    @property
    def last_buffered_arrival(self) -> float:
        return (float(self._pending[-1]["arrival"][-1])
                if self._pending else -np.inf)

    def _pull(self) -> bool:
        try:
            wl = next(self._it)
        except StopIteration:
            self._exhausted = True
            return False
        cols = dict(self._on_block(wl, self.n_blocks))
        if "arrival" not in cols:
            cols["arrival"] = np.asarray(wl.arrival, np.float64)
        self._pending.append(cols)
        self.n_blocks += 1
        self.n_rows += int(cols["arrival"].shape[0])
        return True

    def stop(self) -> None:
        """Stop ingesting: the source is treated as exhausted (buffered
        rows still drain) — how a driver bounds an unbounded source."""
        self._exhausted = True

    def take_until(self, t: Optional[float]) -> List[Dict[str, np.ndarray]]:
        """Consume every row with ``float32(arrival) <= t`` (``None`` =
        everything the source has left — only valid on bounded sources).
        Pulls blocks until one ends past ``t``, then splits at the exact
        f32 boundary; returns the consumed column dicts (possibly empty).
        """
        while not self._exhausted and (
                t is None
                or np.float32(self.last_buffered_arrival) <= np.float32(t)):
            if not self._pull():
                break
        out: List[Dict[str, np.ndarray]] = []
        while self._pending:
            seg = self._pending[0]
            arr32 = np.asarray(seg["arrival"], np.float64).astype(np.float32)
            k = (arr32.shape[0] if t is None
                 else int(np.searchsorted(arr32, np.float32(t), side="right")))
            if k == 0:
                break
            if k == arr32.shape[0]:
                out.append(self._pending.pop(0))
            else:
                out.append({f: v[:k] for f, v in seg.items()})
                self._pending[0] = {f: v[k:] for f, v in seg.items()}
                break
        return out


def _raw_columns(wl: M.Workload, block_idx: int) -> Dict[str, np.ndarray]:
    return dict(arrival=np.asarray(wl.arrival, np.float64),
                n_tasks=np.asarray(wl.n_tasks, np.int32),
                task_type=np.asarray(wl.task_type, np.int32),
                task_res=np.asarray(wl.task_res, np.int32),
                exec_time=np.asarray(wl.exec_time, np.float64),
                read_bytes=np.asarray(wl.read_bytes, np.float64),
                write_bytes=np.asarray(wl.write_bytes, np.float64),
                framework=np.asarray(wl.framework, np.int32),
                priority=np.asarray(wl.priority, np.float32))


# ---------------------------------------------------------------------------
# span-export replay
# ---------------------------------------------------------------------------

class SpanSource:
    """Rebuild a workload (and a replay scenario) from a JSONL span export.

    The span schema records, per task, its pipeline's arrival, its
    resource, its executed attempt count, and (with per-attempt recording)
    every attempt's exact ``(start, end)`` slot-hold interval. That is
    sufficient to reconstruct an *equivalent* workload: per-attempt service
    times are the observed intervals verbatim (a failing attempt held its
    slot for exactly that long, whatever ``fail_holds_frac`` produced it),
    IO bytes fold into the observed durations (zero-IO reconstruction — the
    repo's exact-parity configuration), and re-queue delays reproduce from
    the same :class:`~repro_torch.ops.failures.RetryPolicy` backoff.
    Re-simulating on the same platform/policy then reproduces the original
    attempt intervals exactly (tested); swap the schedule, controller, or
    admission policy and the same observed demand replays under the
    what-if.

    Tasks exported stranded (never started) carry no duration; they replay
    with a nominal service and are reported in ``n_approximate``.
    """

    def __init__(self, spans, platform: Optional[M.PlatformConfig] = None,
                 name: str = "replay"):
        from repro_torch.obs.spans import read_spans_jsonl
        if isinstance(spans, (str, bytes)):
            spans = read_spans_jsonl(spans)
        self.platform = platform or M.PlatformConfig()
        self.name = name
        self.n_approximate = 0
        self._build(spans)

    # -- reconstruction -----------------------------------------------------
    def _build(self, spans) -> None:
        # the exporter writes canonical M.RESOURCE_NAMES (plus the res<i>
        # overflow form); accept the replay platform's own names too
        res_idx = {n: i for i, n in enumerate(M.RESOURCE_NAMES)}
        res_idx.update({f"res{i}": i for i in range(
            len(self.platform.resources))})
        res_idx.update({r.name: i
                        for i, r in enumerate(self.platform.resources)})
        type_idx = {n: i for i, n in enumerate(M.TASK_TYPE_NAMES)}
        pipes, tasks, atts = {}, {}, {}
        for s in spans:
            a = s.get("attributes", {})
            if s["kind"] == "pipeline":
                pipes[a["pipeline"]] = float(s["start_s"])
            elif s["kind"] == "task":
                tasks[(a["pipeline"], a["task_pos"])] = (
                    s["name"].partition(":")[2], a.get("resource"),
                    int(a.get("attempts", 1)), s["start_s"], s["end_s"])
            elif s["kind"] == "attempt":
                atts[(a["pipeline"], a["task_pos"], a["attempt"])] = (
                    s["start_s"], s["end_s"])
        if not pipes:
            raise ValueError("no pipeline spans in the export")
        # rows in arrival order (original pids break ties), as a synthesized
        # workload would order them
        pids = sorted(pipes, key=lambda p: (pipes[p], p))
        self.pipeline_ids = np.asarray(pids, np.int64)
        row_of = {p: i for i, p in enumerate(pids)}
        n = len(pids)
        arrival = np.asarray([pipes[p] for p in pids], np.float64)
        n_tasks = np.zeros(n, np.int32)
        tt = np.full((n, MAX_TASKS), -1, np.int32)
        tres = np.zeros((n, MAX_TASKS), np.int32)
        exec_t = np.zeros((n, MAX_TASKS), np.float64)
        attempts = np.ones((n, MAX_TASKS), np.int64)
        A = max([a for (_, _, a) in atts] or [0]) + 1
        att_svc = np.zeros((n, MAX_TASKS, A), np.float64)
        for (pid, pos), (tname, rname, n_att, t0, t1) in tasks.items():
            i = row_of[pid]
            n_tasks[i] = max(n_tasks[i], pos + 1)
            ttype = type_idx.get(tname, M.TRAIN)
            tt[i, pos] = ttype
            tres[i, pos] = (res_idx[rname] if rname in res_idx
                            else int(self.platform.route(
                                np.asarray([ttype]))[0]))
            attempts[i, pos] = n_att
            durs = []
            for a in range(n_att):
                iv = atts.get((pid, pos, a))
                if iv is not None and iv[0] is not None and iv[1] is not None:
                    durs.append(float(iv[1]) - float(iv[0]))
            if not durs:
                # no attempt spans: a clean single attempt runs start->end;
                # multi-attempt legacy exports (or stranded tasks) can only
                # replay approximately
                if t0 is not None and t1 is not None and n_att <= 1:
                    durs = [float(t1) - float(t0)]
                else:
                    durs = [((float(t1) - float(t0)) / max(n_att, 1))
                            if t0 is not None and t1 is not None else 1e-2]
                    self.n_approximate += 1
            exec_t[i, pos] = durs[0]
            pad = durs + [durs[-1]] * (A - len(durs))
            att_svc[i, pos, :] = pad[:A]
        zeros2 = np.zeros((n, MAX_TASKS))
        self.workload = M.Workload(
            arrival=arrival, n_tasks=n_tasks, task_type=tt, task_res=tres,
            exec_time=exec_t, read_bytes=zeros2, write_bytes=zeros2.copy(),
            framework=np.zeros(n, np.int32),
            priority=np.zeros(n, np.float32),
            model_perf=np.zeros(n, np.float32),
            model_size=np.zeros(n, np.float32),
            model_clever=np.zeros(n, np.float32))
        self._attempts = attempts
        self._att_svc = att_svc if A > 1 else None

    # -- TraceSource --------------------------------------------------------
    def blocks(self) -> Iterator[M.Workload]:
        yield self.workload

    # -- replay -------------------------------------------------------------
    def scenario(self, schedule=None, controller=None, backoff=None,
                 horizon_s: Optional[float] = None):
        """The replay :class:`~repro_torch.ops.scenario.CompiledScenario`:
        the
        *observed* attempt counts and per-attempt slot-hold times, under an
        exchangeable schedule/controller (the what-if knobs). ``backoff``
        must match the original run's retry policy for re-queue delays to
        reproduce (default: :class:`~repro_torch.ops.failures.RetryPolicy`'s).
        ``controller`` is a
        :class:`~repro_torch.ops.capacity.ReactiveController`
        (compiled against this source's platform) or a pre-compiled
        ControllerParams tensor."""
        from repro_torch.ops.capacity import static_schedule
        from repro_torch.ops.failures import RetryPolicy
        from repro_torch.ops.scenario import CompiledScenario
        if controller is not None and hasattr(controller, "compile"):
            if horizon_s is None:
                raise ValueError("pass horizon_s to compile a controller "
                                 "for the replay")
            controller = controller.compile(self.platform.capacities,
                                            horizon_s)
        return CompiledScenario(
            schedule=(schedule if schedule is not None
                      else static_schedule(self.platform.capacities)),
            attempts=self._attempts,
            backoff=tuple(backoff) if backoff is not None
            else RetryPolicy().backoff,
            attempt_service=self._att_svc,
            controller=controller)

    def remap_pipelines(self, rec):
        """Map a replay's row-indexed ``rec.pipeline`` back to the original
        export's pipeline ids (rows were re-ordered by arrival), so replayed
        records compare key-for-key against the original export."""
        import dataclasses as _dc
        return _dc.replace(rec, pipeline=self.pipeline_ids[
            np.asarray(rec.pipeline, np.int64)])
