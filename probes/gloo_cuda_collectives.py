#!/usr/bin/env python3
"""Which collectives a gloo process group takes on CUDA tensors, with two
ranks sharing one card (NCCL refuses two ranks on one device).

Run on a machine with one CUDA card:

    python3 probes/gloo_cuda_collectives.py

Two spawned ranks, both on cuda:0, join a gloo group on 127.0.0.1. Each
collective is tried on float32 and int32 CUDA tensors and reported as
"ok" (right values on both ranks), "wrong" or the error it raised; then
the DeviceMesh and DTensor calls the port's sharded path makes
(`init_device_mesh("cuda", ...)` at (1, 2) and (2, 1) with named dims,
`get_group`, `DTensor.from_local`, `distribute_tensor(src_data_rank=
None)`) and the wall of an all-reduce of 23.7 MB. Prints each result as
it comes (a collective that crashes its rank is the last one named) and
one JSON object per rank. Then two more ranks try DTensor's
`full_tensor` alone, which took a rank down with SIGSEGV on torch 2.11
(the port gathers with the c10d calls instead).
"""
from __future__ import annotations

import json
import socket
import sys
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"rank": rank, "torch": torch.__version__}

    def attempt(name, fn):
        print(f"[rank {rank}] {name} ...", flush=True)
        try:
            out[name] = "ok" if fn() else "wrong"
        except Exception as e:          # a probe: report and go on
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        print(f"[rank {rank}] {name}: {out[name]}", flush=True)
        dist.barrier()

    for dt in (torch.float32, torch.int32):
        tag = str(dt).removeprefix("torch.")
        base = torch.arange(4, device=dev).to(dt) + 10 * rank

        def all_reduce():
            t = base.clone()
            dist.all_reduce(t)
            return t.tolist() == [10 + 2 * i for i in range(4)]

        def all_gather_into_tensor():
            t = torch.empty(8, device=dev, dtype=dt)
            dist.all_gather_into_tensor(t, base)
            return t.tolist() == [i for i in range(4)] + [10 + i
                                                          for i in range(4)]

        def all_gather():
            ts = [torch.empty(4, device=dev, dtype=dt) for _ in range(world)]
            dist.all_gather(ts, base)
            return torch.cat(ts).tolist() == [i for i in range(4)] + [
                10 + i for i in range(4)]

        def reduce_scatter_tensor():
            t = torch.empty(2, device=dev, dtype=dt)
            dist.reduce_scatter_tensor(t, base)
            want = [(i + 10 + i) for i in range(4)][2 * rank:2 * rank + 2]
            return t.tolist() == want

        def broadcast():
            t = base.clone()
            dist.broadcast(t, 0)
            return t.tolist() == list(range(4))

        for name, fn in (("all_reduce", all_reduce),
                         ("broadcast", broadcast),
                         ("all_gather", all_gather),
                         ("reduce_scatter_tensor", reduce_scatter_tensor),
                         ("all_gather_into_tensor", all_gather_into_tensor)):
            attempt(f"{name} {tag}", fn)

    # the wall of an all-reduce of the 64-row LM head's f32 output
    import time
    big = torch.ones(64, 92544, device=dev)
    for reps in (1, 5):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            dist.all_reduce(big)
        torch.cuda.synchronize()
        out[f"all_reduce {big.numel() * 4} bytes x{reps}, ms a call"] = \
            (time.monotonic() - t0) * 1e3 / reps
    print(f"[rank {rank}] {out}", flush=True)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    meshes = {}
    for shape in ((1, 2), (2, 1)):
        key = f"mesh {shape}"
        try:
            mesh = init_device_mesh("cuda", shape,
                                    mesh_dim_names=("data", "model"))
            out[key] = (f"ok: {mesh}; model group size "
                        f"{dist.get_world_size(mesh.get_group('model'))}, "
                        f"backend {dist.get_backend(mesh.get_group('model'))}")
        except Exception as e:
            out[key] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            continue
        print(f"[rank {rank}] {key}: {out[key]}", flush=True)
        full = torch.arange(8.0, device=dev).reshape(2, 4)
        pl = [Replicate(), Shard(1)] if shape == (1, 2) else \
            [Shard(0), Replicate()]
        meshes[shape] = (mesh, full, pl)

        def from_local():
            local = distribute_tensor(full, mesh, pl,
                                      src_data_rank=None).to_local()
            d = DTensor.from_local(local, mesh, pl, run_check=False)
            return tuple(d.shape) == (2, 4) and local.numel() == 4

        attempt(f"{key} distribute_tensor+from_local", from_local)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _full_tensor_rank(rank: int, world: int, port: int) -> None:
    """DTensor's own redistribution (functional collectives), apart: it
    may take the process down."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    full = torch.arange(8.0, device=dev).reshape(2, 4)
    d = distribute_tensor(full, mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    print(f"[rank {rank}] mesh (1, 2) full_tensor: "
          f"{'ok' if torch.equal(d.full_tensor(), full) else 'wrong'}",
          flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    mp.start_processes(_rank, args=(2, _free_port()), nprocs=2, join=True,
                       start_method="spawn")
    try:
        mp.start_processes(_full_tensor_rank, args=(2, _free_port()),
                           nprocs=2, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        print(f"mesh (1, 2) full_tensor: a rank died: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
