"""End-to-end training CLI on one device (port of `repro/launch/train.py`).

Wires together: config registry -> model -> train step -> synthetic data
pipeline -> checkpoint manager -> fault tolerance (preemption guard +
straggler watchdog). Runs on the CUDA card unless --device says
otherwise. Weights are drawn from --seed (`Model.init`; they are not the
reference's, whose numbers jax.random draws), and the batch of step k is
the pipeline's batch k, so --resume continues the exact stream.
--production-mesh and --dot-shard wait for the sharded port (ROADMAP
section 1, item 8) and are refused.

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \
      --smoke --device cpu --steps 4 --batch 4 --seq 32 --ckpt-dir /tmp/ck
On the card, the reference example's settings:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \
      --steps 200 --batch 8 --seq 256 --ckpt-every 100
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.numerics import EngineSpec
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.distributed.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.distributed.train import build_train_step, init_train_state
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig

_NO_MESH = ("runs on one device: the mesh and the sharded GEMMs wait for "
            "the sharded port (ROADMAP section 1, item 8)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="refused: " + _NO_MESH)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    # Numerics override as an EngineSpec (core/numerics.py): route the
    # training GEMMs through a registered DotEngine mode.
    ap.add_argument("--dot-mode", default=None,
                    help="DotEngine mode for the run's weight GEMMs "
                         "(e.g. olm16, olm32t16); default: the config's")
    ap.add_argument("--dot-tiling", default=None, choices=("auto",),
                    help="'auto' = shape-aware autotuned grid tiling")
    ap.add_argument("--dot-shard", default=None, choices=("m", "n", "k"),
                    help="refused: " + _NO_MESH)
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh: the port " + _NO_MESH)
    if args.dot_shard is not None:
        ap.error("--dot-shard: the port " + _NO_MESH)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    data = SyntheticLMDataset(cfg, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=3)

    state = init_train_state(model, args.seed)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(state)
        print(f"resumed from step {start_step}")
    spec_kw = {}
    if args.dot_mode is not None:
        spec_kw["mode"] = args.dot_mode
    if args.dot_tiling is not None:
        spec_kw["tiling"] = args.dot_tiling
    engine_spec = EngineSpec(**spec_kw) if spec_kw else None
    step_fn = build_train_step(
        model, opt_cfg=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        schedule_total=args.steps,
        engine_spec=engine_spec)

    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt: print(f"  [watchdog] step {s} straggled: {dt:.2f}s"))
    losses = []
    with PreemptionGuard() as guard:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in data.batch(step).items()}
            watchdog.start()
            state, metrics = step_fn(state, batch)
            if model.device.type == "cuda":
                # the step's wall ends when its kernels have run
                torch.cuda.synchronize(model.device)
            loss = float(metrics["loss"])
            watchdog.stop(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
            if (step + 1) % args.ckpt_every == 0 or guard.preempted:
                ckpt.save(step + 1, state)
            if guard.preempted:
                print("preempted: checkpoint saved, exiting cleanly")
                break
    if not guard.preempted:
        # (the reference saves here after a preemption too, under
        # --steps, so that a resume would skip the steps not run)
        ckpt.save(args.steps, state, block=True)
    ckpt.wait()
    summary = {
        "arch": cfg.name, "steps": len(losses),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "loss_improved": bool(losses and losses[-1] < losses[0]),
        "stragglers": watchdog.flagged,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
