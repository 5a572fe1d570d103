#!/usr/bin/env python3
"""Whether the check of the sharded train step on the ("data", "model")
mesh (2, 1) can fail: the step run as it is, and with each of three
faults planted at run time, held against the single-device step.

Run on a machine with one CUDA card (InternLM2-1.8B at full width, its
depth cut to 4 layers, 3 steps of 4 x 128 from seed 0 at lr 3e-3, the
`shard` phase of chip_smoke.py):

    python3 probes/sharded_train_faults.py

or on the CPU at smoke width (2 layers, 4 x 16, lr 3e-4, the sharded
tests' case):

    PYTHONPATH=src python3 probes/sharded_train_faults.py --smoke

On (2, 1) the batch splits over "data" and each rank's gradients are
summed across the two ranks, so that is the reduction the faults break:

  sum_skipped   the gradients are not summed (each rank trains on its
                own half of the batch; the loss is still summed);
  one_half      both ranks run rank 0's rows (the sum and the divide
                are right, the data is not);
  no_divide     the summed gradients are not divided by the 2 ranks.

Each run is read three ways against the single-device step: each step's
loss and grad_norm as relative differences, and the update (params after
minus params before) as the relative norm of its difference,
|p_sharded - p_one| / |p_one - p_start|. The limits are
`tests/test_torch_sharded_train.py`'s on the CPU (loss 1e-5, grad_norm
1e-3, update 5e-2) and chip_smoke.py's on the card (loss 2.5e-4: there
the bf16 GEMMs of 256 rows and of 512 differ in their last bits, and the
sound step's loss moves by ~2.6e-5). Two spawned ranks share one device
in a gloo group on 127.0.0.1. Prints one JSON object with every reading, and each
run's verdict; exits 1 unless the sound run is within every limit and
each fault is outside one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

LIMITS = {"cpu": {"loss": 1e-5, "grad_norm": 1e-3, "update": 5e-2},
          "cuda": {"loss": 2.5e-4, "grad_norm": 1e-3, "update": 5e-2}}
FAULTS = ("sound", "sum_skipped", "one_half", "no_divide")


def _setup(smoke: bool, device: str):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    cfg = dataclasses.replace(
        smoke_config("internlm2_1_8b") if smoke else
        get_config("internlm2_1_8b"), n_layers=2 if smoke else 4)
    B, S = (4, 16) if smoke else (4, 128)
    data = SyntheticLMDataset(cfg, B, S, seed=0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in data.batch(i).items()} for i in range(3)]
    opt = dict(opt_cfg=AdamWConfig(lr=3e-4 if smoke else 3e-3),
               schedule_total=10_000 if smoke else 30)
    return Model(cfg, device=device), batches, opt, B


def _run(step, state, batches):
    seen = []
    for b in batches:
        state, met = step(state, b)
        seen.append([float(met["loss"]), float(met["grad_norm"])])
    return state, seen


def _rank(rank: int, world: int, port: int, tmp: str, smoke: bool,
          device: str) -> None:
    import torch.distributed as dist
    from repro_torch.distributed import train as dtrain
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import tree_leaves
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        model, batches, opt, B = _setup(smoke, device)
        want = torch.load(os.path.join(tmp, "params.pt"), mmap=True)
        meta = json.loads(open(os.path.join(tmp, "one.json")).read())
        sharder = Sharder(make_local_mesh(2, 1, device_type=device.split(
            ":")[0]), model.cfg)
        sharder.set_batch(B)
        real = dtrain.all_reduce_sum
        out = {}
        for fault in FAULTS:
            # every fault is planted here, at run time, and taken out
            # again; the 0-d tensors summed beside the gradients are the
            # loss and aux
            if fault == "sum_skipped":
                dtrain.all_reduce_sum = (
                    lambda t, m, a: real(t, m, a) if t.ndim == 0 else t)
            elif fault == "no_divide":
                dtrain.all_reduce_sum = (
                    lambda t, m, a: real(t, m, a) if t.ndim == 0
                    else real(t, m, a).mul_(2))
            run = batches
            if fault == "one_half":
                half = B // 2
                run = [{k: torch.cat([v[:half], v[:half]]) for k, v in
                        b.items()} for b in batches]
            try:
                state = dtrain.distribute_state(
                    sharder, dtrain.init_train_state(model, 0))
                state, seen = _run(dtrain.build_train_step(
                    model, sharder, **opt), state, run)
            finally:
                dtrain.all_reduce_sum = real
            got = tree_leaves(dtrain.gather_state(state["params"]))
            diff = sum(float((g.double() - w.to(g.device).double()).pow(2)
                             .sum()) for g, w in zip(got, want)) ** 0.5
            out[fault] = {
                "loss": max(abs(s[0] - o[0]) / abs(o[0])
                            for s, o in zip(seen, meta["metrics"])),
                "grad_norm": max(abs(s[1] - o[1]) / abs(o[1])
                                 for s, o in zip(seen, meta["metrics"])),
                "update": diff / meta["update_norm"],
                "metrics": seen}
            print(f"[rank {rank}] {fault}: " + json.dumps(
                {k: v for k, v in out[fault].items() if k != "metrics"}),
                flush=True)
            del state, got
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="smoke width and depth 2, the CPU tests' case")
    ap.add_argument("--device", default=None,
                    help="default: cuda:0, or cpu with --smoke")
    args = ap.parse_args()
    device = args.device or ("cpu" if args.smoke else "cuda:0")
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device: run with --smoke on the CPU", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    from repro_torch.distributed.train import (build_train_step,
                                               init_train_state)
    from repro_torch.tree import tree_leaves
    if device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        model, batches, opt, _ = _setup(args.smoke, device)
        state = init_train_state(model, 0)
        start = tree_leaves(state["params"])
        state, seen = _run(build_train_step(model, **opt), state, batches)
        end = tree_leaves(state["params"])
        norm = sum(float((e.double() - s.double()).pow(2).sum())
                   for e, s in zip(end, start)) ** 0.5
        torch.save([t.cpu() for t in end], os.path.join(tmp, "params.pt"))
        with open(os.path.join(tmp, "one.json"), "w") as f:
            json.dump({"metrics": seen, "update_norm": norm}, f)
        print(f"one device: loss, grad_norm by step {seen}; update norm "
              f"{norm}; largest |update| "
              f"{max(float((e - s).abs().max()) for e, s in zip(end, start))}",
              flush=True)
        del model, state, start, end
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank, args=(2, port, tmp, args.smoke, device),
                           nprocs=2, join=True, start_method="spawn")
        ranks = [json.loads(open(os.path.join(tmp, f"rank{r}.json")).read())
                 for r in range(2)]
    limits = LIMITS[device.split(":")[0]]
    verdict = {}
    for fault in FAULTS:
        verdict[fault] = [k for k in limits
                          if max(r[fault][k] for r in ranks) > limits[k]]
    ok = not verdict["sound"] and all(verdict[f] for f in FAULTS[1:])
    if device.startswith("cuda"):
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(json.dumps({"device": device, "limits": limits,
                      "readings": {f: [{k: r[f][k] for k in limits}
                                       for r in ranks] for f in FAULTS},
                      "outside": verdict, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
