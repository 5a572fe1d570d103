#!/usr/bin/env python3
"""Whether the checks of the partitioned train step (`distributed/
train.py::jit_train_step`) can fail: the step run as it is, and with each
of three faults planted at run time, held against the port's one-device
step on the same params and batch.

    PYTHONPATH=src python3 probes/tp_train_faults.py

Four gloo ranks on the CPU, a (data 2, model 2) mesh, the smoke-width
configs of `tests/test_torch_tp_train.py` at f32 compute, one batch of
4 x 8 rows (2 a data rank). The faults:

  model_sum_skipped  the backward of `Partition.enter` (a layer's input,
                     whole over `model`, going into the rank's columns)
                     leaves each rank's partial gradient unsummed
                     (InternLM2, tp);
  data_slice         the backward of `Partition.whole_over_data` (a
                     weight gathered over `data` under fsdp_tp) keeps the
                     rank's block of its gradient instead of summing it
                     over `data` (Yi, fsdp_tp, its table tied);
  norm_per_rank      the global norm counts a replicated leaf (the norm
                     scales) once a rank along `model` (InternLM2).

Each run is read two ways against the one-device step: the largest
difference of a rank's gradient block over its leaf's largest |g|, over
every leaf and rank (the test's gradient check), and the relative
difference of grad_norm (the test's metric check); both limits are the
test's 1e-5. Prints one JSON object with every reading and each run's
verdict; exits 1 unless the sound runs are within both limits and each
fault is outside one.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

LIMIT = 1e-5
RUNS = {"sound_tp": ("heads", None), "model_sum_skipped": ("heads", "model"),
        "norm_per_rank": ("heads", "norm"),
        "sound_fsdp": ("fsdp_length_tied", None),
        "data_slice": ("fsdp_length_tied", "data")}


def _plant(fault):
    """Patch the fault in; returns the undo."""
    from repro_torch.distributed import collectives as c
    from repro_torch.distributed import train as t
    from repro_torch.launch.mesh import MODEL_AXIS
    saved = (c._Enter.backward, c._GatherOver.backward, t._block_norm)
    if fault == "model":
        c._Enter.backward = staticmethod(lambda ctx, g: (g, None, None))
    elif fault == "data":
        real = c._GatherOver.backward

        def sliced(ctx, g):
            if ctx.axis == MODEL_AXIS:
                return real(ctx, g)
            r, size = c.axis_coordinate(ctx.mesh, ctx.axis)
            n = g.shape[ctx.dim] // size
            return g.narrow(ctx.dim, r * n, n).contiguous(), None, None, None
        c._GatherOver.backward = staticmethod(sliced)
    elif fault == "norm":
        real_norm = t._block_norm

        def per_rank(blocks, split, mesh):
            return real_norm(blocks, [axes or (MODEL_AXIS,)
                                      for axes in split], mesh)
        t._block_norm = per_rank

    def undo():
        c._Enter.backward, c._GatherOver.backward = (
            staticmethod(saved[0]), staticmethod(saved[1]))
        t._block_norm = saved[2]
    return undo


def _rank(rank, world, port, out_dir):
    import torch.distributed as dist
    from repro_torch.distributed.collectives import shard_dims
    from repro_torch.distributed.sharding import Sharder, path_leaves
    from repro_torch.distributed.train import (_grads_of,
                                               cast_params,
                                               distribute_state,
                                               init_train_state,
                                               jit_train_step)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import global_norm
    from torch_rank_cases import (TP_MESH, TP_TRAIN_BATCH, tp_config,
                                  tp_train_batches)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_local_mesh(*TP_MESH, device_type="cpu")
        for run, (case, fault) in RUNS.items():
            cfg = tp_config(case)
            model = Model(cfg, device="cpu")
            sharder = Sharder(mesh, cfg)
            sharder.set_batch(TP_TRAIN_BATCH)
            whole = init_train_state(model, 0)
            batch = {k: torch.from_numpy(v)
                     for k, v in tp_train_batches(cfg)[0].items()}
            _, _, one = _grads_of(model, whole["params"], batch,
                                  lambda p: cast_params(p, cfg))
            one = dict(path_leaves(one))
            state = distribute_state(sharder, whole)
            specs = sharder.batch_specs(list(batch))
            rows = {k: shard_dims(v, specs[k], mesh)
                    for k, v in batch.items()}
            undo = _plant(fault)
            try:
                step = jit_train_step(model, sharder, state, list(batch))
                _, _, got = step.grads(state, rows)
                _, met = step(state, rows)
            finally:
                undo()
            worst = 0.0
            for path, g in path_leaves(got):
                w = one[path]
                block = shard_dims(w, sharder.param_spec(path, tuple(
                    w.shape)), mesh)
                worst = max(worst, float((g - block).abs().max())
                            / max(float(w.abs().max()), 1e-30))
            want = float(global_norm(list(one.values())))
            out[run] = {"grad": worst, "grad_norm": abs(
                float(met["grad_norm"]) - want) / want}
    finally:
        torch.save(out, os.path.join(out_dir, f"faults{rank}.pt"))
        dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp
    from torch_rank_cases import free_port
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(4, free_port(), tmp), nprocs=4,
                           join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"faults{r}.pt"))
                 for r in range(4)]
    readings = {run: {k: max(r[run][k] for r in ranks)
                      for k in ("grad", "grad_norm")} for run in RUNS}
    verdict = {}
    for run, (_, fault) in RUNS.items():
        within = all(v <= LIMIT for v in readings[run].values())
        verdict[run] = ("within both limits" if within else
                        "outside " + ", ".join(k for k, v in readings[
                            run].items() if v > LIMIT))
    ok = all((RUNS[run][1] is None) == verdict[run].startswith("within")
             for run in RUNS)
    print(json.dumps({"limit": LIMIT, "readings": readings,
                      "verdict": verdict, "ok": ok}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
