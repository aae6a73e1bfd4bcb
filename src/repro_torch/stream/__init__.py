"""Streaming trace ingestion and replay (mirrors :mod:`repro.stream`).

The fixed-horizon workload tensor becomes one *source* among several: a
:class:`TraceSource` yields arrival-ordered workload blocks, a
:class:`WorkloadManager` buffers and window-slices them, and
:func:`stream_simulate` runs the stream through the batched engine in
resumable horizon windows — bit-identical to materializing the whole stream
into one call (:func:`oneshot_reference`, gated by :func:`parity_drift`),
with the working set bounded by the live backlog instead of the stream's
length.
"""
from repro_torch.stream.driver import (StreamResult, oneshot_reference,
                                       parity_drift, stream_simulate)
from repro_torch.stream.sources import (SpanSource, SyntheticSource,
                                        TraceSource, WorkloadManager,
                                        materialize)

__all__ = [
    "TraceSource", "SyntheticSource", "SpanSource", "WorkloadManager",
    "materialize", "stream_simulate", "oneshot_reference", "parity_drift",
    "StreamResult",
]
