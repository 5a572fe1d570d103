"""End-to-end training CLI (port of `repro/launch/train.py`).

Wires together: config registry -> model -> sharder -> partitioned train
step (`jit_train_step`, as the reference's CLI runs; each rank its blocks
of the state and its rows of each batch) -> synthetic data pipeline -> checkpoint manager -> fault tolerance
(preemption guard + straggler watchdog). Runs on the CUDA card unless
--device says otherwise. Weights are drawn from --seed (`Model.init`; they
are not the reference's, whose numbers jax.random draws), and the batch of
step k is the pipeline's batch k, so --resume continues the exact stream.

The world comes from the environment `torchrun` sets (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE); with none set it
is one rank. The ranks join a process group and a (world, 1)
("data", "model") mesh, the reference's local mesh. --backend auto (the
default) picks NCCL where each rank of a host has a card of its own, and
gloo where the ranks share a card (NCCL refuses two ranks on one device;
gloo takes CUDA tensors for every collective of the sharded path, through
the host), run on the CPU, or are one rank (nothing moves between ranks);
the first line says which, and why. --dot-shard shards
the olm GEMMs over its "model" axis; the step is then the whole layout
(`build_train_step`), whose GEMMs the engine shards itself. --production-mesh builds the 16x16
Sharder's specs and stops before the first step unless the world has
its 256 ranks.

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \
      --smoke --device cpu --steps 4 --batch 4 --seq 32 --ckpt-dir /tmp/ck
On the card, the reference example's settings:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \
      --steps 200 --batch 8 --seq 256 --ckpt-every 100
Two ranks, on a host's first two cards (NCCL) or sharing one card (gloo):
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch mamba2_130m --steps 20 --batch 8 --seq 256
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.numerics import EngineSpec
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.distributed.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.distributed.sharding import Sharder, path_leaves
from repro_torch.distributed.collectives import shard_dims
from repro_torch.distributed.train import (build_train_step,
                                           init_train_state, jit_train_step,
                                           state_shardings)
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                    mesh_shape)
from repro_torch.models.model import Model, resolve_device
from repro_torch.optim.adamw import AdamWConfig


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
                    help="the 16x16 mesh's specs; stops unless the world "
                         "has its 256 ranks")
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
                    help="shard olm GEMMs over the mesh 'model' axis: "
                         "m/n = output-sharded (bit-identical), k = "
                         "summed contraction (within olm_error_bound)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "gloo", "nccl"),
                    help="process group backend; auto: NCCL where each "
                         "rank of a host has a card of its own, else gloo")
    args = ap.parse_args(argv)

    device = args.device
    if device is None and torch.cuda.is_available():
        # torchrun's ranks of a host take its cards in turn
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the world torchrun describes, else one rank (the group is this
    # call's, and ends with it)
    owned = not dist.is_initialized()
    if owned:
        backend, why = pick_backend(args.backend, dev, int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1))))
    else:
        backend, why = dist.get_backend(), "the caller's group"
    # NCCL binds each rank to its card (else it guesses from the global
    # rank, wrong past a host's first cards)
    bind = {"device_id": dev} if backend == "nccl" else {}
    if owned and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **bind)
    elif owned:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **bind)
    try:
        return _train(args, dev, why)
    finally:
        if owned:
            dist.destroy_process_group()


def pick_backend(flag: str, dev: torch.device, local_world: int):
    """(the process group's backend, why): `flag` unless it is "auto";
    then NCCL where each of the host's `local_world` ranks has a card of
    its own, gloo where they share one, run on the CPU or are one."""
    if flag != "auto":
        return flag, "--backend"
    if dev.type != "cuda":
        return "gloo", f"the ranks run on the {dev.type}"
    if local_world == 1:
        return "gloo", "one rank: nothing moves between ranks"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card(s), and "
                        "NCCL takes one card a rank")
    return "nccl", f"each of the {local_world} ranks has a card of its own"


def _train(args, dev: torch.device, why: str):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.production_mesh:
        mesh = make_production_mesh()
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(args.batch)
        specs = sharder.param_specs(Model(cfg, device="meta").init(args.seed))
        say(f"production mesh {mesh.shape}: specs of "
            f"{len(path_leaves(specs))} param leaves, batch "
            f"{sharder.batch_spec()}")
        if mesh.size > world:
            raise mesh.unplaced(world)
    else:
        mesh = make_local_mesh(data=world, device_type=dev.type)
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(args.batch)
    say(f"mesh {mesh_shape(mesh)} over {world} "
        f"rank(s), backend {dist.get_backend()} ({why}), device {dev}")
    model = Model(cfg, device=dev)
    data = SyntheticLMDataset(cfg, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=3)

    state = init_train_state(model, args.seed, sharder=sharder)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(state, shardings=state_shardings(sharder,
                                                              state))
        say(f"resumed from step {start_step}")
    spec_kw = {}
    if args.dot_mode is not None:
        spec_kw["mode"] = args.dot_mode
    if args.dot_tiling is not None:
        spec_kw["tiling"] = args.dot_tiling
    if args.dot_shard is not None:
        spec_kw["shard"] = args.dot_shard
    engine_spec = EngineSpec(**spec_kw) if spec_kw else None
    step_kw = dict(opt_cfg=AdamWConfig(lr=args.lr),
                   microbatches=args.microbatches,
                   compress_grads=args.compress_grads,
                   schedule_total=args.steps, engine_spec=engine_spec)
    bspecs = sharder.batch_specs(["tokens"])    # the stream's one key
    if args.dot_shard is None:
        # the reference's jit_train_step: this rank's blocks and rows
        step_fn = jit_train_step(model, sharder, state, list(bspecs),
                                 **step_kw)
    else:
        # every GEMM sharded by the engine itself: the whole layout, each
        # rank handed the whole batch
        step_fn = build_train_step(model, sharder, **step_kw)
        bspecs = {k: (None,) for k in bspecs}

    def rows(batch):
        return {k: shard_dims(torch.from_numpy(v), bspecs[k], mesh).to(
            model.device) for k, v in batch.items()}

    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt: say(f"  [watchdog] step {s} straggled: {dt:.2f}s"))
    losses = []
    with PreemptionGuard() as guard:
        for step in range(start_step, args.steps):
            batch = rows(data.batch(step))
            watchdog.start()
            state, metrics = step_fn(state, batch)
            if model.device.type == "cuda":
                # the step's wall ends when its kernels have run
                torch.cuda.synchronize(model.device)
            loss = float(metrics["loss"])
            watchdog.stop(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}")
            if (step + 1) % args.ckpt_every == 0 or guard.preempted:
                ckpt.save(step + 1, state)
            if guard.preempted:
                say("preempted: checkpoint saved, exiting cleanly")
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
    say(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
