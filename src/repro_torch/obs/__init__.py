"""In-simulation telemetry of the PyTorch port (mirrors :mod:`repro.obs`):
the in-loop probes and the OTel-style span export of task records and
in-engine actions, with JSONL and Chrome-trace writers, and the
simulator's self-profiler."""
from repro_torch.obs.probes import (CompiledProbe, ProbeSpec, ProbeTimeline,
                                    compile_probe, probe_channel_names)
from repro_torch.obs.profile import (profile_compile_execute,
                                     profile_numpy, stage_attribution)
from repro_torch.obs.spans import (attempt_intervals,
                                   attempt_intervals_from_records,
                                   build_spans,
                                   read_chrome_attempt_intervals,
                                   read_spans_jsonl, write_chrome_trace,
                                   write_spans_jsonl)

__all__ = [
    "ProbeSpec", "CompiledProbe", "ProbeTimeline", "compile_probe",
    "probe_channel_names",
    "build_spans", "write_spans_jsonl", "read_spans_jsonl",
    "write_chrome_trace", "attempt_intervals",
    "attempt_intervals_from_records", "read_chrome_attempt_intervals",
    "profile_compile_execute", "profile_numpy", "stage_attribution",
]
