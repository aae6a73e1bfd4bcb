#!/usr/bin/env python3
"""How many PyTorch operations one wave of the batched engine dispatches,
with every stage of the wave loop on and with none.

Run from the repository root (CPU; no card needed):

    python3 tools/count_wave_ops.py

It builds ``chip_smoke.py``'s full-stack oracle ensemble (4 whole-second
one-tenth days with a controller, reliability events, a fleet and a probe)
and runs it through ``simulate_ensemble`` on the CPU twice: as built, and
with the stage inputs dropped. A ``TorchDispatchMode`` counts every ATen
operation the engine dispatches, views included, over the waves the loop
runs (a multiple of ``sync_every``). The wave loop on the card is bound by
the host's dispatch of these operations, so the count per wave is what its
time per wave follows. Prints one JSON object: the operations per wave in
both runs and the operation kinds the stages add, most frequent first.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STAGE_INPUTS = ("controllers", "n_ctrl_slots", "fleets", "trig", "obs_noise",
                "drift_inc", "pool_gain", "pool_base", "n_pool_eff",
                "probes", "n_probe_slots", "rel_times", "rel_deltas",
                "n_rel_slots")
SYNC_EVERY = 64


def count_ops(cols, caps, pols):
    """``(ATen operations by kind, waves the loop ran)``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import batching, vdes

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    tensors = batching.to_tensors(cols, "cpu")
    with Count() as c:
        out = vdes.simulate_ensemble(**tensors, capacities=caps,
                                     policies=pols, device="cpu",
                                     sync_every=SYNC_EVERY)
    waves = math.ceil(int(out["waves"].max()) / SYNC_EVERY) * SYNC_EVERY
    return c.n, waves


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cols, caps, pols = smoke.fullstack_oracle_ensemble()[:3]
    full, w_full = count_ops(cols, caps, pols)
    bare, w_bare = count_ops({k: v for k, v in cols.items()
                              if k not in STAGE_INPUTS}, caps, pols)
    added = {k: full[k] / w_full - bare.get(k, 0) / w_bare for k in full}
    print(json.dumps({
        "ops_per_wave_all_stages": sum(full.values()) / w_full,
        "ops_per_wave_no_stage": sum(bare.values()) / w_bare,
        "waves": {"all_stages": w_full, "no_stage": w_bare},
        "added_per_wave": {k: round(v, 2) for k, v in sorted(
            added.items(), key=lambda kv: -kv[1]) if v >= 0.5}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
