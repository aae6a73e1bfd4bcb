#!/usr/bin/env python3
"""Time ``CheckpointManager.restore`` on llama3.2-1b's full-width train
state on the card, against ``np.load``'s reader of the same file.

Run from the repository root with one CUDA device:

    python3 tools/bench_restore.py [--out DIR]

The state is ``trainer.init_train_state`` of the full-width config from
seed 0 (bf16 parameters, f32 moments: 12.4 GB), saved once with
``save(block=True)`` into a temporary directory (``TMPDIR``). The two
readers then restore it onto the card in turns (``np.load``, the manager,
the manager, ``np.load``), each restore timed by the host clock to a
``torch.cuda.synchronize()`` and held bit for bit against the saved state.
The file is warm in the page cache after the save: no cold read is timed.
Prints one line per measurement and writes them, with the card's name and
power limit, to ``DIR/restore_bench.json`` (default ``build/bench/``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def np_load_restore(path, target):
    """The restore as ``np.load`` reads an ``.npz``: every leaf read in
    256 KiB pieces into fresh host memory, then copied to its device."""
    from repro_torch.checkpoint.manager import _DTYPES_KEY, _from_host
    with np.load(path) as z:
        dtypes = json.loads(str(z[_DTYPES_KEY]))

        def build(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (k,)) for k, v in tree.items()}
            name = "/".join(prefix)
            return _from_host(z[name], dtypes.get(name)).to(
                device=tree.device, dtype=tree.dtype)

        return build(target)


def same_bits(torch, a, b) -> bool:
    from repro_torch.models.common import tree_leaves
    return all(torch.equal(x.detach().reshape(-1).view(torch.uint8),
                           y.detach().reshape(-1).view(torch.uint8))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "bench"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_restore: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = configs.get_config("llama3.2-1b")
    st = trainer.init_train_state(cfg, adamw.AdamWConfig(), 0, "cuda")
    state = {"params": st.params, "opt_state": st.opt_state}
    rec = {"card": card, "runs": []}
    with tempfile.TemporaryDirectory(prefix="bench_restore_") as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(1, state, block=True)
        rec["save_s"] = time.perf_counter() - t0
        rec["bytes"] = os.path.getsize(mgr.path(1))
        print(f"save {rec['save_s']:.2f} s, {rec['bytes'] / 1e9:.3f} GB; "
              f"card: {card}", flush=True)
        for kind in ("np.load", "manager", "manager", "np.load"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = (np_load_restore(mgr.path(1), state)
                    if kind == "np.load" else mgr.restore(1, state))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ok = same_bits(torch, back, state)
            del back
            rec["runs"].append({"reader": kind, "s": secs, "bit_for_bit": ok})
            print(f"restore ({kind}): {secs:.2f} s, bit for bit {ok}",
                  flush=True)
            if not ok:
                return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "restore_bench.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
