"""The dry run (port of `repro/launch/dryrun.py`): walk one rank's step of
every (arch x shape x mesh) cell on meta tensors over a fake world.

For each cell the dry run:
  1. makes a fake world of 256 ranks (16 x 16) or 512 (2 x 16 x 16) with
     torch's "fake" process group backend (every collective returns at
     once and moves nothing), this process its rank 0, and over it a
     DeviceMesh with the axis names and sizes of `make_production_mesh`;
     the world is the cell's, and goes with it;
  2. builds the model and the Sharder on that mesh, and the step's
     arguments as meta tensors (`input_specs`), and walks the
     "partitioned" layout (the record's `layout`), every family's: train
     runs `jit_train_step(model, sharder, ..., microbatches=...)` on this
     rank's blocks of the f32 train state (`init_train_state(model,
     sharder=)`) and its rows of the batch; prefill and decode
     `jit_prefill_step` / `jit_decode_step` on this rank's blocks of the
     bf16 serve params (`init_serve_params`), of the batch (and of the
     decode's memory) and of the cache at the Sharder's specs; each moves
     its collectives over `model` and, under fsdp_tp, `data` (the SSM
     family, whose weights are replicated, only its gradients' sum).
     `cell_step` also keeps the "whole" layout, to compare the two: the
     train step `build_train_step` on the state `distribute_state`
     rests, every param gathered whole; `build_prefill_step` /
     `build_decode_step` on whole bf16 serve params (f32 leaves of 2 or
     more dims cast, the reference's `_serve_params` rule), the rank's
     rows of the batch and a cache of its rows, no collective;
  3. runs that step once under `roofline.walk`: dot FLOPs, the bytes each
     op reads and writes, the live bytes and their peak, the collectives
     by kind and mesh axis;
  4. records them with the three roofline terms against H100 SXM peaks.

Nothing is allocated on any device, and the dry run needs no card, as
the reference compiles on host devices (`hold_against_card`, the check of
a walk against the same step on the card, needs one). A cell whose peak exceeds the
card's 80 GB is a finding, not a failure; only an exception fails a cell.

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2_1_8b \\
      --shape train_4k [--multi-pod | --both-meshes] [--all] \\
      [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.collectives import shard_dims
from repro_torch.distributed.sharding import Sharder
from repro_torch.distributed.train import (build_decode_step,
                                           build_prefill_step,
                                           build_train_step,
                                           distribute_state,
                                           init_serve_cache,
                                           init_serve_params,
                                           init_train_state,
                                           jit_decode_step,
                                           jit_prefill_step, jit_train_step,
                                           serve_params)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (axis_links, collective_bytes,
                                         roofline_terms, walk)
from repro_torch.launch.shapes import (SHAPES, ShapeCase, applicable,
                                      case_specs)
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

__all__ = ["run_cell", "walk_cell", "eval_shape_tree", "main",
           "fake_world", "production_mesh", "cell_step", "serve_params",
           "serve_layout", "microbatches", "hold_against_card", "card_step",
           "CARD_BYTES"]

CARD_BYTES = 80e9          # an H100 SXM's HBM3


def microbatches(cfg, case: ShapeCase) -> int:
    """The reference's accumulation: 8 microbatches for a train step of
    more than 20e9 params, else 1 (serve kinds 1)."""
    if case.kind != "train":
        return 1
    return 8 if cfg.param_count() > 20e9 else 1


def eval_shape_tree(fn: Callable, *args):
    """fn run on meta stand-ins: every tensor of args replaced by a meta
    tensor of its shape and dtype, and every factory call inside fn on
    the meta device; returns fn's tree of meta tensors (the port's
    `jax.eval_shape`)."""
    def meta(x):
        return (torch.empty_like(x, device="meta")
                if isinstance(x, torch.Tensor) else x)
    with torch.device("meta"):
        return fn(*tree_map(meta, args))


def serve_layout(cfg) -> str:
    """The layout a cell of `cfg` walks: "partitioned", as every family
    has partitioned serve steps and a partitioned train step (the dense,
    MoE, recurrent, SSM and cross-attention families)."""
    return "partitioned"


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of `size` ranks on torch's fake backend,
    this process rank 0, for the duration of the block. Refuses to start
    over an existing default group."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the "
                           "dry run makes its own fake world")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("torch's fake process group backend cannot be "
                           f"imported ({e}); the dry run needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(*, multi_pod: bool):
    """The DeviceMesh of `make_production_mesh`'s names and sizes over the
    ranks of the default group (which must hold them), for meta tensors."""
    return _meta_mesh(make_production_mesh(multi_pod=multi_pod))


def _meta_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(shape.size).reshape(shape.axis_sizes)
    return DeviceMesh("cpu", ranks, mesh_dim_names=shape.axis_names)


def walk_cell(cfg, case: ShapeCase, shape, layout: Optional[str] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any], Any]:
    """Rank 0's step of `case` walked on meta over a fake world of the
    ranks of `shape` (an AbstractMesh: `make_production_mesh`'s, or a
    small one to hold against ranks on a card): (the walk's counts, its
    collective bytes by kind and axis, the batch axes)."""
    with fake_world(shape.size):
        mesh = _meta_mesh(shape)
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(case.global_batch)
        fn, args = cell_step(Model(cfg, device="meta"), sharder, case,
                             case_specs(cfg, case), layout)
        counts = walk(fn, *args, mesh=mesh)
        del fn, args
        coll = collective_bytes(counts["collectives"], axis_links(mesh))
        return counts, coll, sharder.batch_spec()[0]


def cell_step(model: Model, sharder: Sharder, case: ShapeCase,
              inputs: Dict[str, Any], layout: Optional[str] = None
              ) -> Tuple[Callable, tuple]:
    """(the step one rank runs for `case`, its arguments) on the model's
    device: meta for the walk, the card to hold the walk against it.
    `inputs`: `input_specs`'s entries, or tensors of their shapes. A case
    keeps `layout` ("partitioned" or "whole"; `serve_layout(cfg)` by
    default): a partitioned train case runs `jit_train_step` on the
    blocks `init_train_state(model, sharder=)` draws and the rank's rows,
    a whole one `build_train_step` on the state `distribute_state` rests
    (every param gathered whole in the step) and the whole batch."""
    cfg = model.cfg
    bd = sharder.batch_spec()[0]

    def rows(t):
        """this rank's rows of a (B, ...) input, held on their own"""
        return shard_dims(t, (bd,) + (None,) * (t.ndim - 1),
                          sharder.mesh).clone()

    partitioned = (layout or serve_layout(cfg)) == "partitioned"
    if case.kind == "train" and partitioned:
        state = init_train_state(model, sharder=sharder)
        batch = {k: rows(v) for k, v in inputs["batch"].items()}
        step = jit_train_step(model, sharder, state, list(batch),
                              microbatches=microbatches(cfg, case))
        return step, (state, batch)
    if case.kind == "train":
        state = distribute_state(sharder, init_train_state(model))
        step = build_train_step(model, sharder,
                                microbatches=microbatches(cfg, case))
        return step, (state, inputs["batch"])
    if partitioned:
        params = init_serve_params(model, sharder)
        cache = init_serve_cache(model, sharder, case.global_batch,
                                 case.seq_len)
        if case.kind == "prefill":
            batch = {k: rows(v) for k, v in inputs["batch"].items()}
            return jit_prefill_step(model, sharder, params, list(batch),
                                    cache), (params, batch, cache)
        args = (params, rows(inputs["token"]), rows(inputs["pos"]), cache)
        if "memory" in inputs:
            args += (rows(inputs["memory"]),)
        return jit_decode_step(model, sharder, params, cache,
                               has_memory="memory" in inputs), args
    params = serve_params(model.init())
    if case.kind == "prefill":
        batch = {k: rows(v) for k, v in inputs["batch"].items()}
        cache = model.init_cache(batch["tokens"].shape[0], case.seq_len)
        return build_prefill_step(model), (params, batch, cache)
    token, pos = rows(inputs["token"]), rows(inputs["pos"])
    cache = model.init_cache(token.shape[0], case.seq_len)
    args = (params, token, pos, cache)
    if "memory" in inputs:
        args += (rows(inputs["memory"]),)
    return build_decode_step(model), args


def _card_inputs(cfg, case: ShapeCase, device) -> Dict[str, Any]:
    """Tensors on `device` of `case_specs`'s shapes, from seed 0: tokens in
    the vocabulary, every position at the middle of the cache, frontend
    embeddings and memory N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(0)

    def real(name, t):
        if name in ("tokens", "token"):
            return torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                                 device=device, dtype=t.dtype)
        if name == "pos":
            return torch.full(t.shape, case.seq_len // 2, device=device,
                              dtype=t.dtype)
        return torch.randn(t.shape, generator=g, device=device).to(t.dtype)

    out = {}
    for name, spec in case_specs(cfg, case).items():
        if name == "batch":
            out[name] = {k: real(k, v) for k, v in spec.items()}
        elif name != "case":
            out[name] = real(name, spec)
    return out


def hold_against_card(cfg, case: ShapeCase) -> Dict[str, Any]:
    """One rank's step of `case` walked on meta and then run on the card,
    on a one-rank mesh (a gloo world of one, made here and destroyed
    before returning; it refuses an existing default group): the walk's
    record (`walk`, with its roofline `terms`) and the card's
    (`card`: the dot FLOPs FlopCounterMode counts over the step, the
    peak `torch.cuda.max_memory_allocated()` reads above what was
    allocated before the step's arguments were made, the fastest of three
    synchronized walls after that step); weights and inputs from seed 0.
    Needs a CUDA card and raises without one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the walk is held against a card")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: the "
                           "check makes its own world of one rank")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # the walk's mesh holds meta tensors, the card's CUDA ones
        sharders = {side: Sharder(make_local_mesh(1, 1, device_type=side),
                                  cfg) for side in ("cpu", "cuda")}
        for sharder in sharders.values():
            sharder.set_batch(case.global_batch)
        mesh = sharders["cpu"].mesh
        fn, args = cell_step(Model(cfg, device="meta"), sharders["cpu"],
                             case, case_specs(cfg, case))
        pred = walk(fn, *args, mesh=mesh)
        del fn, args
        coll = collective_bytes(pred["collectives"], axis_links(mesh))
        pred["terms"] = roofline_terms(pred, coll, n_chips=1, cfg=cfg,
                                       case=case)

        return {"walk": pred, "card": card_step(cfg, case, sharders["cuda"])}
    finally:
        dist.destroy_process_group()


def card_step(cfg, case: ShapeCase, sharder: Sharder) -> Dict[str, Any]:
    """This rank's step of `case` (`cell_step`, weights and inputs from
    seed 0) run on its card, in the process group the sharder's CUDA mesh
    lies on: the dot FLOPs FlopCounterMode counts over the step, the peak
    `torch.cuda.max_memory_allocated()` reads above what was allocated
    before the step's arguments were made, the fastest of three
    synchronized walls after that step."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = torch.device("cuda", torch.cuda.current_device())
    # tensors left in reference cycles (a first call's lazy set-up leaves
    # some) die only when the collector runs: collect on both sides of the
    # baseline
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fn, args = cell_step(Model(cfg, device=dev), sharder, case,
                         _card_inputs(cfg, case, dev))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        res = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del res
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    del fn, args
    return {"flops": int(fc.get_total_flops()), "peak": peak,
            "wall_s": min(walls), "walls_s": walls}


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: Path
             ) -> dict:
    cfg = get_config(arch)
    case = SHAPES[shape]
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16", "skipped": not ok}
    if not ok:
        rec["skip_reason"] = why
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.time()
    counts, coll, batch_axes = walk_cell(cfg, case, mesh)
    rec.update({
        "walk_s": round(time.time() - t0, 1),
        "microbatches": microbatches(cfg, case),
        "batch_axes": batch_axes,
        "bytes_per_device": counts["bytes_per_device"],
        "fits": counts["bytes_per_device"]["peak"] <= CARD_BYTES,
        "flops": counts["flops"],
        "bytes_accessed": counts["bytes"],
        "ops": counts["ops"],
        "collectives": coll,
        "roofline": roofline_terms(counts, coll, n_chips=n_chips, cfg=cfg,
                                   case=case),
        "device": "none: meta tensors over a fake process group",
    })
    rec["layout"] = serve_layout(cfg)
    out_dir.mkdir(parents=True, exist_ok=True)
    fn = out_dir / f"{arch}__{shape}__{rec['mesh']}.json"
    fn.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = Path(args.out)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, out_dir=out)
                    if rec.get("skipped"):
                        print(f"SKIP {tag}: {rec['skip_reason']}", flush=True)
                        continue
                    peak = rec["bytes_per_device"]["peak"]
                    roof = rec["roofline"]
                    print(f"OK   {tag}: peak {peak / 1e9:.2f} GB/rank of "
                          f"{CARD_BYTES / 1e9:.0f} GB "
                          f"({'fits' if rec['fits'] else 'DOES NOT FIT'}), "
                          f"flops {rec['flops']:.3g}, bytes "
                          f"{rec['bytes_accessed']:.3g}, coll "
                          f"{rec['collectives']['total_bytes']:.3g} B, "
                          f"{roof['dominant']} {roof['bound_s']:.3g} s, "
                          f"walk {rec['walk_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 - a cell's failure
                    failures += 1
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc(limit=3)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
