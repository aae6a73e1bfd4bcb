"""End-to-end driver: train a ~100M-param llama-family model for a few
hundred steps on the synthetic data pipeline, with checkpointing and an
injected fault + restart mid-run. It trains through the plain attention
route: the kernels refuse autograd.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]
"""
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _common import arg_parser  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402

STEPS = 300


def main(device=None, steps: int = STEPS, batch: int = 8, seq: int = 256,
         ckpt_every: int = 50, log_every: int = 20, ckpt_dir=None):
    """Returns the first and last logged losses, whether the loss fell and
    the number of restarts. ``ckpt_dir=None`` checkpoints into a fresh
    temporary directory, removed at the end (an old checkpoint would be
    resumed from)."""
    dev = resolve_device(device)
    tmp = None
    if ckpt_dir is None:
        ckpt_dir = tmp = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    try:
        # smoke=True scales the config down to ~100M-class dims; pass a
        # full config (smoke=False) for the published widths.
        out = run_training(
            "llama3.2-1b", steps=steps, batch=batch, seq=seq, smoke=True,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            fault_at=[steps // 2], lr=1e-3, log_every=log_every, device=dev)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    result = {"first_loss": first, "last_loss": last,
              "improved": last < first, "restarts": out["restarts"]}
    print(json.dumps(result, indent=2))
    assert last < first, "training did not reduce loss"
    return result


if __name__ == "__main__":
    ap = arg_parser(__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--ckpt-dir", default=None)
    main(**vars(ap.parse_args()))
