"""In-simulation telemetry of the PyTorch port (mirrors :mod:`repro.obs`):
the in-loop probes. The reference's span export and self-profiler are not
ported."""
from repro_torch.obs.probes import (CompiledProbe, ProbeSpec, ProbeTimeline,
                                    compile_probe, probe_channel_names)

__all__ = ["ProbeSpec", "CompiledProbe", "ProbeTimeline", "compile_probe",
           "probe_channel_names"]
