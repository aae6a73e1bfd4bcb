"""Restartable training launcher (mirrors :mod:`repro.launch.train`), on the
card.

End-to-end driver: synthetic data pipeline -> train step -> checkpoint
manager, with crash-restart (injected faults included), straggler
monitoring, and restore onto the current device, or onto the mesh given
(a checkpoint from any mesh restores onto it).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 200 --batch 8 --seq 128 --fault-at 50 --ckpt-every 20

runs the smoke config (``--smoke`` is the default, as in the reference);
``--full`` takes the full-width config and ``--device cpu`` runs on the
CPU. Weights are random (seed 0) and the data synthetic. Training runs
the plain attention and SSD routes, the reference's defaults: the kernels
have no backward.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch import configs as CN
from repro_torch.checkpoint.manager import (CheckpointManager, FaultInjector,
                                            StragglerMonitor)
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train import trainer

MAX_RESTARTS = 8
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def run_training(arch: str, *, steps: int, batch: int, seq: int,
                 smoke: bool = True, ckpt_dir: str = DEFAULT_CKPT_DIR,
                 ckpt_every: int = 50, fault_at=(), lr: float = 3e-4,
                 log_every: int = 10, resume: bool = True, mesh=None,
                 fsdp: bool = False, microbatches: int = 1,
                 injector: FaultInjector = None, device=None,
                 on_step=None) -> dict:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens on
    ``device`` (``None``: the card), checkpointing every ``ckpt_every``
    steps (0: only the final checkpoint) into ``ckpt_dir``.

    A fault (``RuntimeError``, among them the injected ones: ``fault_at``
    steps, or an ``injector`` such as
    :meth:`repro_torch.reliability.CheckpointSpec.injector` gives) rolls
    back to the latest checkpoint, and the data replays from its step;
    after ``MAX_RESTARTS`` restarts the fault is raised. A restart first
    waits for a checkpoint still being written, so it resumes from the last
    one saved before the fault. Returns ``history`` (the logged steps' loss
    and seconds), ``restarts``, ``restored_from`` (for each restart, the
    step of the checkpoint it resumed from, 0 where none was written yet),
    ``straggler_steps``, ``final_step``, the final ``state`` (``params``,
    ``opt_state``) and ``save_s``, the seconds of the final checkpoint's
    write (``block=True``).

    On a ``mesh`` (every rank of its world calls with the same arguments;
    ``device`` is the mesh's device type) the state is built whole from
    the seed and placed by ``trainer.state_shardings(cfg, mesh, fsdp=)``,
    each step runs this rank's rows of the global batch, checkpoints are
    gathered and written by rank 0, and a restart restores onto the mesh.
    ``on_step(step, state)``, if given, sees the state after each step."""
    if injector is not None and fault_at:
        raise ValueError("give fault_at or an injector, not both")
    dev = resolve_device(device)
    cfg = CN.get_smoke_config(arch) if smoke else CN.get_config(arch)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 20, 5))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq,
                      family=cfg.family, n_ctx=cfg.n_ctx, d_ctx=cfg.d_ctx,
                      d_model=cfg.d_model)
    step_fn = trainer.make_train_step(cfg, opt_cfg, mesh, fsdp=fsdp,
                                      microbatches=microbatches)
    state_sh = None     # the placements of params and moments on the mesh
    if mesh is not None:
        sh = trainer.state_shardings(cfg, mesh, fsdp=fsdp)
        state_sh = {"params": sh["params"], "opt_state": sh["opt_state"]}
    mgr = CheckpointManager(ckpt_dir, keep_last=3)
    injector = injector if injector is not None \
        else FaultInjector(list(fault_at))
    watchdog = StragglerMonitor()

    params = None
    opt_state = None
    start_step = 0
    history = []
    restarts = 0
    restored_from = []

    while True:  # crash-restart loop
        try:
            if params is None:
                state = trainer.init_train_state(cfg, opt_cfg, 0, dev)
                params, opt_state = state.params, state.opt_state
                if state_sh is not None:
                    placed = trainer.shard_state(
                        {"params": params, "opt_state": opt_state}, state_sh)
                    params, opt_state = placed["params"], placed["opt_state"]
                mgr.wait()      # an async save in flight finishes first
                latest = mgr.latest_step() if resume else None
                if restarts:
                    restored_from.append(latest or 0)
                if latest is not None:
                    state = mgr.restore(latest, {"params": params,
                                                 "opt_state": opt_state},
                                        state_sh)
                    params = trainer.trainable(state["params"])
                    opt_state = state["opt_state"]
                    start_step = latest
                    print(f"[restore] resumed from step {latest}")

            for step in range(start_step, steps):
                t0 = time.perf_counter()
                batch_data = synth_batch(dcfg, step, dev)
                if "ctx" in batch_data:
                    # the pipeline's bf16 patches, in the model's compute
                    # dtype (the model takes no other; bf16 -> f32 is exact)
                    batch_data["ctx"] = batch_data["ctx"].to(cfg.cdt)
                injector.maybe_fail(step)
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch_data)
                loss = float(metrics["loss"])    # waits for the device
                dt = time.perf_counter() - t0
                if on_step is not None:
                    on_step(step, {"params": params, "opt_state": opt_state})
                slow = watchdog.record(step, dt)
                if step % log_every == 0 or step == steps - 1:
                    history.append({"step": step, "loss": loss,
                                    "sec": dt, "straggler": slow})
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"{dt*1e3:7.1f} ms{' [STRAGGLER]' if slow else ''}",
                          flush=True)
                if ckpt_every and (step + 1) % ckpt_every == 0:
                    mgr.save(step + 1, {"params": params,
                                        "opt_state": opt_state})
            break
        except RuntimeError as e:
            print(f"[fault] {e} -> restarting from latest checkpoint")
            restarts += 1
            params = None
            opt_state = None
            start_step = 0
            if restarts > MAX_RESTARTS:
                raise

    state = {"params": params, "opt_state": opt_state}
    t0 = time.perf_counter()
    mgr.save(steps, state, block=True)
    save_s = time.perf_counter() - t0
    mgr.wait()
    return {"history": history, "restarts": restarts,
            "restored_from": restored_from,
            "straggler_steps": watchdog.flagged, "final_step": steps,
            "state": state, "save_s": save_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=CN.ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fault-at", type=int, action="append", default=[])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = run_training(args.arch, steps=args.steps, batch=args.batch,
                       seq=args.seq, smoke=args.smoke,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       fault_at=args.fault_at, lr=args.lr,
                       microbatches=args.microbatches, device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("history", "state")}, indent=2))


if __name__ == "__main__":
    main()
