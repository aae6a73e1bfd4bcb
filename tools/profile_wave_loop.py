#!/usr/bin/env python3
"""Where the batched wave loop's time goes on one NVIDIA GPU.

Run from the repository root with one CUDA device:

    python3 tools/profile_wave_loop.py [--out build/profile]

It builds the main path of ``chip_smoke.py`` (32 one-day replicas) and
runs it three times on the card:

1. plain, timed by the host clock around a synchronised call (the wall);
2. with the admission kernel wrapped to count the queued rows of every
   launch on the device (no host sync);
3. under ``torch.profiler``, stepped once per wave by the same wrapper,
   recording ``WINDOW`` waves in the middle of the run: device busy time
   (the union of kernel intervals in the exported trace), the idle share,
   kernels per wave and the kernels that take the device time.

Prints one JSON object (also written to ``<out>/profile_wave_loop.json``,
the trace to ``<out>/profile_wave_loop_trace.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SKIP_WAVES = 4000        # the profiled window starts after this many waves
WINDOW = 200             # ... and records this many


class AdmissionTap:
    """Stands in for ``fused_admission`` inside the engine: launches it and,
    per call, optionally records queue statistics or steps a profiler."""

    def __init__(self, kernel, record=False, prof=None):
        self.kernel, self.record, self.prof = kernel, record, prof
        self.calls = 0
        self.q_sum = self.q_max = None

    def __call__(self, res_q, pkey, enq_wave, free):
        if self.record:
            q = (res_q < free.shape[1]).sum(1)                 # [R] queued
            self.q_sum = q if self.q_sum is None else self.q_sum + q
            self.q_max = q if self.q_max is None else \
                self.q_max.maximum(q)
        self.calls += 1
        out = self.kernel(res_q, pkey, enq_wave, free)
        if self.prof is not None:
            self.prof.step()
        return out


def busy_union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def trace_breakdown(path, waves):
    events = json.loads(Path(path).read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    if not kern or not ops:
        raise RuntimeError(f"the trace holds {len(kern)} device and "
                           f"{len(ops)} host events; nothing to break down")
    t0 = min(e["ts"] for e in ops)
    t1 = max(max(e["ts"] + e["dur"] for e in kern),
             max(e["ts"] + e["dur"] for e in ops))
    busy = busy_union_us((e["ts"], e["ts"] + e["dur"]) for e in kern)
    by_kernel = defaultdict(float)
    for e in kern:
        by_kernel[e["name"]] += e["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    adm = sum(v for k, v in by_kernel.items() if "fused_admission" in k)
    return dict(window_waves=waves, window_ms=(t1 - t0) / 1e3,
                wall_per_wave_ms=(t1 - t0) / 1e3 / waves,
                device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / (t1 - t0),
                kernels_per_wave=len(kern) / waves,
                host_op_events_per_wave=len(ops) / waves,
                admission_kernel_share_of_busy=adm / busy,
                top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_wave_loop: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import batching, vdes
    from repro_torch.kernels import queue_scan

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    plats, wls, comps, pols, cols, caps = cs.build_ensemble()
    t = batching.to_tensors(cols, "cuda")
    kernel = queue_scan.fused_admission

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vdes.simulate_ensemble(**t, capacities=caps, policies=pols,
                                     device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, wall = run()                                   # 1. the wall
    waves = int(res["waves"].max())

    tap = AdmissionTap(kernel, record=True)             # 2. queue lengths
    vdes.fused_admission = tap
    try:
        run()
    finally:
        vdes.fused_admission = kernel
    q_mean = (tap.q_sum.double() / tap.calls).cpu().numpy()

    sched = torch.profiler.schedule(wait=SKIP_WAVES, warmup=5,
                                    active=WINDOW, repeat=1)
    trace_path = out_dir / "profile_wave_loop_trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=sched) as prof:
        vdes.fused_admission = AdmissionTap(kernel, prof=prof)
        try:
            run()                                       # 3. the profile
        finally:
            vdes.fused_admission = kernel
    prof.export_chrome_trace(str(trace_path))
    breakdown = trace_breakdown(trace_path, WINDOW)

    report = dict(
        card=card, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, replicas=len(wls), n_max=int(cols["n_max"]),
        wall_s=wall, waves=waves, waves_per_s=waves / wall,
        pipelines_per_s=sum(w.n for w in wls) / wall,
        queued_rows_per_launch_mean=float(q_mean.mean()),
        queued_rows_per_launch_max=int(tap.q_max.max()),
        queued_share_mean=float(q_mean.mean() / cols["n_max"]),
        profile=breakdown)
    text = json.dumps(report, indent=1)
    (out_dir / "profile_wave_loop.json").write_text(text)
    print(text)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
