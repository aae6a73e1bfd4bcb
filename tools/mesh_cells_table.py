"""Prints the dry-run's ``single`` and ``multi`` records as one markdown
table, one row per arch and a column per shape and mesh: per-device FLOPs
/ bytes / collective bytes, the dominant roofline term on
``costmodel.H100`` (c compute, m memory, n collective) and the cell's
FLOPs over the ``h100x1`` cell's. These are counts from the meta device,
not times.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --workers 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single \
        --workers 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi \
        --workers 4
    python3 tools/mesh_cells_table.py

``--root DIR`` reads ``DIR/dryrun_torch/`` (the dry-run's ``--root``).
``--dp`` prints instead the FSDP cells' DP gathers per step (the records'
``dp_gather``): gathers (the forward's and a remat's recompute),
re-gathers (the backward's, in place of a saved gathered block) and
reduce-scatters, each ``count / GiB``, and the most gathered GiB alive at
once.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as CN  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402

MESHES = ("single", "multi")
TERM = {"compute": "c", "memory": "m", "collective": "n"}


def cell(rec, one) -> str:
    if rec is None:
        return "not counted"
    if rec["status"] != "ok":
        return rec["status"]
    coll = sum(v["bytes"] for v in rec["collectives"].values())
    dom = TERM[costmodel.roofline_terms(rec)["dominant"]]
    out = (f"{rec['flops_per_device']:.3g} / "
           f"{rec['bytes_accessed_per_device']:.3g} / {coll:.3g} {dom}")
    if one is not None and one.get("status") == "ok":
        out += f" x{one['flops_per_device'] / rec['flops_per_device']:.4g}"
    return out


def dp_cell(rec) -> str:
    if rec is None or rec.get("status") != "ok" or not rec.get("fsdp"):
        return "—"
    g = rec["dp_gather"]
    gib = lambda n: f"{n / 2**30:.3g}"
    return (f"{g['gathers']} / {gib(g['gathered_bytes'])}; "
            f"{g['regathers']} / {gib(g['regathered_bytes'])}; "
            f"{g['reduce_scatters']} / {gib(g['scattered_bytes'])}; "
            f"{gib(g['high_bytes'])}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--dp", action="store_true")
    args = ap.parse_args(argv)
    cols = [(sh, m) for sh in CN.SHAPES for m in MESHES]
    if args.dp:
        print("| arch | " + " | ".join(f"{sh} {m}" for sh, m in cols) + " |")
        print("|---" * (len(cols) + 1) + "|")
        for arch in CN.ARCHS:
            row = [dp_cell(costmodel.load_cell(m, arch, sh, root=args.root))
                   for sh, m in cols]
            if any(c != "—" for c in row):
                print(f"| {arch} | " + " | ".join(row) + " |")
        return
    print("| arch | " + " | ".join(f"{sh} {m}" for sh, m in cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for arch in CN.ARCHS:
        row = [cell(costmodel.load_cell(m, arch, sh, root=args.root),
                    costmodel.load_cell("h100x1", arch, sh, root=args.root))
               for sh, m in cols]
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
