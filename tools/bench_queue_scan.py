#!/usr/bin/env python3
"""Time the ``queue_scan`` kernel on the card, route by route, and against
an earlier version of its source.

Run from the repository root with one CUDA device and the CUDA toolkit:

    python3 tools/bench_queue_scan.py [--baseline OLD.cu] [--out DIR]

The inputs are ``chip_smoke.py`` phase 12's: 4,096 stations of 4,096 jobs
per capacity, from the same generator and seed. Every time is CUDA events
over calls one after another (``chip_smoke.cuda_ms``), as phase 12 times
the kernel.

- Routes: at each capacity of the sweep and at the routes' boundaries,
  every route ``(S, G)`` of ``csrc/queue_scan.cu`` whose width holds the
  capacity is launched through ``queue_scan_launch_route``, held bit for
  bit against the route ``queue_scan_launch`` takes, and timed.
- A yardstick: the same bytes moved by ``Tensor.copy_`` (ready into
  start, service into finish), the rate at which this card streams them.
- ``--baseline OLD.cu``: a source with the same ``queue_scan_launch``
  entry point, built with the same ``nvcc`` flags, and the kernel are
  timed in turns (baseline, kernel, kernel, baseline) at each capacity of
  the sweep, their outputs held bit for bit against each other.

Prints one line per measurement and writes everything, with the card's
name and power limit and ptxas's registers and spills of every kernel,
to ``DIR/queue_scan_bench.json`` (default ``build/bench/``).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ROUTE_CAPS = cs.QUEUE_CAPS + (8, 16, 128, 256)


def ptxas_table(log: str) -> list:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log;
    the template arguments of a ``queue_scan_kernel<S, G, VEC>`` as
    ``S,G,VEC``."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out.append(dict(kernel=fn, template=",".join(
                re.findall(r"Li(\d+)E", fn))))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def build_baseline(_build, src: Path):
    """``src`` built with the kernels' own flags into the build directory;
    returns the loaded library and its ptxas table."""
    data = src.read_bytes()
    key = hashlib.sha256(data + " ".join(_build.NVCC_FLAGS).encode())
    so = _build.BUILD_DIR / f"libqueue_scan_baseline-{key.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.queue_scan_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.queue_scan_launch.restype = ctypes.c_int
    return lib, ptxas_table(proc.stdout + proc.stderr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bench")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_queue_scan: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import queue_scan as qs

    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    lib = _build.load("queue_scan", qs._QUEUE_SIGNATURES)
    rec = dict(card=card, device=torch.cuda.get_device_name(0),
               method="CUDA events over calls one after another "
                      f"({args.iters} calls, 2 warm-up)",
               ptxas=ptxas_table(_build.build_log("queue_scan")))
    for k in rec["ptxas"]:
        cs.log(f"ptxas {k['template'] or k['kernel']}: {k.get('registers')}"
               f" registers, {k.get('spill_stores')} B spill stores, "
               f"{k.get('spill_loads')} B spill loads")
    stream = torch.cuda.current_stream().cuda_stream
    R, N = cs.QUEUE_R, cs.QUEUE_N
    gen = torch.Generator(device="cuda").manual_seed(15)

    def launcher(fn, r, s, *extra):
        st, fi = torch.empty_like(r), torch.empty_like(r)

        def go():
            err = fn(r.data_ptr(), s.data_ptr(), st.data_ptr(),
                     fi.data_ptr(), R, N, *extra, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        return go, (st, fi)

    def timed(go):
        return cs.cuda_ms(go, iters=args.iters, warmup=2)

    baseline = None
    if args.baseline is not None:
        baseline, rec["baseline_ptxas"] = build_baseline(_build,
                                                         args.baseline)
        rec["baseline"] = str(args.baseline)
    rec["routes"], rec["turns"] = [], []
    for c in ROUTE_CAPS:
        r, s = cs.queue_jobs(torch, gen, c)
        bound = max(cs.queue_bound(R, N, c))
        want_go, want = launcher(lib.queue_scan_launch, r, s, c)
        want_go()
        default = qs.kernel_route(c)
        if c == cs.QUEUE_CAPS[0]:
            st, fi = torch.empty_like(r), torch.empty_like(r)
            rec["copy_ms"] = timed(lambda: (st.copy_(r), fi.copy_(s)))
            cs.log(f"copy_ of the same bytes: {rec['copy_ms']:.6f} ms")
        for S, G in qs.ROUTES:
            if S * G < c:
                continue
            go, got = launcher(lib.queue_scan_launch_route, r, s, c, S, G)
            go()
            torch.cuda.synchronize()
            if not all(cs.same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"route ({S}, {G}) differs at c = {c}")
            ms = timed(go)
            rec["routes"].append(dict(c=c, S=S, G=G, ms=ms, bound_ms=bound,
                                      default=(S, G) == default))
            mark = " *" if (S, G) == default else ""
            cs.log(f"c = {c}: route ({S}, {G}){mark} {ms:.6f} ms (bound "
                   f"{bound:.6f} ms)")
        if baseline is not None and c in cs.QUEUE_CAPS:
            base_go, base = launcher(baseline.queue_scan_launch, r, s, c)
            base_go()
            torch.cuda.synchronize()
            if not all(cs.same_bits(a, b) for a, b in zip(base, want)):
                raise AssertionError(f"baseline differs at c = {c}")
            order = [("baseline", base_go), ("kernel", want_go),
                     ("kernel", want_go), ("baseline", base_go)]
            times = [(name, timed(go)) for name, go in order]
            rec["turns"].append(dict(c=c, route=list(default), bound_ms=bound,
                                     order=[n for n, _ in times],
                                     ms=[t for _, t in times]))
            cs.log(f"c = {c}: " + ", ".join(f"{n} {t:.6f}" for n, t in times)
                   + f" ms (bound {bound:.6f} ms)")
        del r, s, want
        torch.cuda.empty_cache()
    if rec["turns"]:
        for name in ("baseline", "kernel"):
            means = [sum(t for n, t in zip(row["order"], row["ms"])
                         if n == name) / 2 for row in rec["turns"]]
            rec[f"{name}_mean_ms"] = sum(means) / len(means)
        cs.log(f"sweep mean: baseline {rec['baseline_mean_ms']:.6f} ms, "
               f"kernel {rec['kernel_mean_ms']:.6f} ms")
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "queue_scan_bench.json").write_text(json.dumps(rec, indent=1))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
