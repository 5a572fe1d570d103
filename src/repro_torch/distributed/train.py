"""The train, prefill and decode step builders (port of
`repro/distributed/train.py`).

Each step keeps one of two layouts:
  * whole: every rank runs the step on whole params, as on one device;
  * partitioned: every rank runs it on its blocks at the Sharder's specs
    under a `Partition` (`partition.py`), as GSPMD partitions the
    reference's jitted steps. No rank holds a whole weight of a
    `model`-sharded leaf, or a whole gradient of one.

Training. `build_train_step` is the whole layout: loss + grad + AdamW
update, with
  * gradient accumulation over microbatches, in the reference's strided
    split: microbatch k holds rows k, k + mb, k + 2 mb, ... of the batch
    (which rows share a microbatch decides the MoE capacity drops and the
    f32 sums), its gradients summed in order and divided by mb;
  * optional int8 error-feedback gradient compression (compress_grads);
  * mixed precision: every f32 leaf the reference casts goes to the
    compute dtype before the forward (`cast_params`), and the gradients
    reach the f32 masters through the cast.
With a `Sharder` the state rests as DTensors with the placements of
`train_state_specs` (`distribute_state`); each step casts this rank's
shards, gathers them whole, runs the forward and backward on its rows,
sums the gradients over the batch axes and runs AdamW on its shards.
An `engine_spec` with `shard=` runs every olm GEMM of that step through
the mesh-sharded front-end on the sharder's mesh.

`jit_train_step` is the partitioned layout, the reference's name and
arguments: the state at `train_state_specs` (`distribute_state`, or
`init_train_state(model, sharder=)`, which draws the blocks without a
whole model), the batch this rank's rows at `batch_specs`. Each step
casts the rank's blocks and gathers nothing whole; the forward and
backward run under the partition context, whose collectives carry a
backward (`partition.py`, `collectives.py`), so each gradient comes in
its block; the gradients are summed over the batch axes their specs do
not split (`data`-split leaves were reduce-scattered over `data` in the
backward already) and divided by the batch axes' size; the global norm
and the compression's max |g| are taken over each leaf's blocks; AdamW
runs on the blocks, in place (the reference's jit donates the state).
The SSM family, whose weights the Sharder replicates, runs the whole
path on its rows, its gradients all-reduced.

A digit-mode engine (olm*, tpmm*) runs its kernel on every GEMM of the
forward, and its derivative is zero, as the reference's
(core/numerics.py `_DigitDot`).

Serving. `build_prefill_step` / `build_decode_step` run `Model.prefill`
/ `decode_step` on whole params and cache, as on one device;
`jit_prefill_step` / `jit_decode_step`, the reference's names and
arguments, run them on this rank's blocks at the Sharder's
`param_specs`, `cache_specs` and `batch_specs` under a `Partition`, the
logits vocab-sharded at P(batch, vocab_axis()), no rank holding more of
the cache than its block; `init_serve_params` draws the blocks without a
whole model ever existing on the rank. The dense, MoE (sliding-window
rings too), recurrent and cross-attention families run under the
partition context (the enc-dec family's encoder too: the prefill
returns the memory as this rank's rows, whole over `model`, and the
decode takes it back); the SSM family runs the whole path on the rank's
rows of the batch and cache, with no collective, as the reference's
compiled program has none.

The collectives are the c10d calls of `distributed.collectives`. The
reference's `with_sharding_constraint` hints have no eager counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.numerics import EngineSpec, resolve_engine
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, lm_loss
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import ef_compress_tree
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import (flatten_like, tree_flatten, tree_map,
                              tree_unflatten)
from .collectives import (all_reduce_max, all_reduce_sum, gather_dims,
                          gather_dtensor, shard_dims)
from .partition import Partition
from .sharding import NamedSharding, Sharder, path_leaves, spec_leaves

__all__ = ["build_train_step", "jit_train_step", "build_prefill_step",
           "build_decode_step", "jit_prefill_step", "jit_decode_step", "MEMORY_KEYS",
           "serve_params", "init_serve_params", "init_serve_cache",
           "param_blocks", "block_shape", "serve_block_bytes",
           "init_train_state", "cast_params", "train_state_specs",
           "distribute_state", "gather_state", "state_shardings"]


def init_train_state(model: Model, seed: int = 0,
                     sharder: Optional[Sharder] = None) -> Dict[str, Any]:
    """The params of `model.init(seed)`, AdamW's zero moments and no
    error state. With a Sharder, this rank's blocks of it at
    `train_state_specs`, as DTensors: `distribute_state` of the whole
    init, bit for bit, but drawn leaf by leaf (each whole leaf cut to its
    block and freed before the next draw), so no whole model exists on
    the rank."""
    if sharder is None:
        params = model.init(seed)
        return {
            "params": params,
            "opt": adamw_init(params),
            "ef": None,  # error state, created on first compressed step
        }

    def keep(path, t):
        return shard_dims(t, sharder.param_spec(path, tuple(t.shape)),
                          sharder.mesh).clone()

    params = model.init(seed, keep=keep)
    shapes = Model(model.cfg, device="meta").init(seed)
    return _at_rest(sharder, {"params": params, "opt": adamw_init(params),
                              "ef": None}, shapes)


def _contiguous_strides(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _at_rest(sharder: Sharder, local, shapes):
    """The train state of this rank's blocks `local` as DTensors at
    `train_state_specs`; `shapes` the whole params (a meta init)."""
    from torch.distributed.tensor import DTensor
    whole = {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                       "step": local["opt"]["step"]},
             "ef": None if local["ef"] is None else shapes}
    _, treedef = tree_flatten(local)
    specs = spec_leaves(train_state_specs(sharder, {
        "params": shapes, "ef": local["ef"]}), local)
    return tree_unflatten(treedef, [
        DTensor.from_local(t, sharder.mesh, sharder.placements(spec),
                           run_check=False, shape=w.shape,
                           stride=_contiguous_strides(w.shape))
        for t, w, spec in zip(tree_flatten(local)[0],
                              flatten_like(whole, treedef), specs)])


def train_state_specs(sharder: Sharder, state) -> Dict[str, Any]:
    """The spec of every leaf of the train state: m, v and the error
    state take their param's, the step is replicated."""
    pspecs = sharder.param_specs(state["params"])
    return {
        "params": pspecs,
        "opt": {"m": pspecs, "v": pspecs, "step": ()},
        "ef": None if state["ef"] is None else pspecs,
    }


def state_shardings(sharder: Sharder, state) -> Dict[str, Any]:
    """The NamedSharding of every leaf of `state` under train_state_specs
    on the sharder's mesh (CheckpointManager.restore's `shardings`).
    `state` may hold only some of the train state's entries (the params
    alone, say)."""
    _, treedef = tree_flatten(state)
    specs = train_state_specs(sharder, {"ef": None, **state})
    return tree_unflatten(treedef, [
        NamedSharding(sharder.mesh, sharder.placements(spec))
        for spec in spec_leaves(specs, state)])


def distribute_state(sharder: Sharder, state) -> Dict[str, Any]:
    """The whole train state (the same on every rank) as DTensors at rest:
    each rank keeps its block of every leaf under train_state_specs."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(
        t, s.mesh, s.placements, src_data_rank=None),
        state, state_shardings(sharder, state))


def gather_state(tree) -> Any:
    """Every DTensor leaf of a tree gathered whole, on every rank."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: gather_dtensor(t) if isinstance(t, DTensor)
                    else t, tree)


def cast_params(params, cfg: ModelConfig):
    """The params the forward runs on: each f32 leaf the reference casts
    goes to cfg.cdtype. The reference casts its f32 leaves of two or more
    dims; its layers of whole pattern groups are stacked over a leading
    group axis there, so every f32 leaf of such a layer is cast (its norm
    scales, biases and recurrent vectors too), while the same 1-D leaves
    of a remainder layer and the top-level ones (final norms) are not. The
    encoder's layers are all whole groups."""
    dt = cfg.cdtype

    def cast(node, stacked: bool):
        return tree_map(lambda p: p.to(dt) if p.dtype == torch.float32 and (
            stacked or p.ndim >= 2) else p, node)

    n_scan = cfg.pattern_groups * len(cfg.block_pattern)
    out = {}
    for key, node in params.items():
        if key == "layers":
            out[key] = [cast(p, i < n_scan) for i, p in enumerate(node)]
        elif key == "encoder":
            out[key] = {"layers": [cast(p, True) for p in node["layers"]],
                        "final_norm": cast(node["final_norm"], False)}
        else:
            out[key] = cast(node, False)
    return out


def _grads_of(model: Model, params, batch, prepare, part=None):
    """(loss, metrics, the gradient of every leaf of `params`) of
    `lm_loss` on `prepare(params)`, under the partition context `part`."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = lm_loss(
        model, prepare(tree_unflatten(treedef, live)), batch, part=part)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    if missing := [i for i, g in enumerate(grads) if g is None]:
        raise RuntimeError(f"leaves {missing} of the params got no "
                           "gradient: the loss does not reach them")
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(treedef, list(grads))


def _accumulated(model: Model, params, batch, prepare, microbatches: int,
                 part=None):
    """(loss, metrics, f32-summed grads / mb) over the microbatches; the
    gradient of a leaf comes in the leaf's dtype."""
    if microbatches == 1:
        return _grads_of(model, params, batch, prepare, part)
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into "
                         f"{microbatches} microbatches")
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    for k in range(microbatches):
        # the reference's (B, ...) -> (B/mb, mb, ...) reshape, swapped:
        # microbatch k is rows k, k + mb, ...
        loss, metrics, g = _grads_of(
            model, params, {n: v[k::microbatches] for n, v in batch.items()},
            prepare, part)
        grads = tree_map(torch.add, grads, g)
        loss_sum = loss_sum + loss
    mb = torch.tensor(float(microbatches), device=model.device)
    return loss_sum / mb, metrics, tree_map(lambda g: g / mb, grads)


def build_train_step(
    model: Model,
    sharder: Optional[Sharder] = None,
    *,
    opt_cfg: Optional[AdamWConfig] = None,
    microbatches: int = 1,
    compress_grads: bool = False,
    schedule_total: int = 10_000,
    engine_spec: Optional[EngineSpec] = None,
):
    """Returns train_step(state, batch) -> (state, metrics), metrics the
    reference's: loss, aux, ppl_proxy (the last microbatch's), grad_norm,
    lr and loss_total (the mean over microbatches of loss + aux term).

    sharder=None steps on one device. With a Sharder the state is the
    one `distribute_state` gives and the step is the sharded one (module
    docstring); every rank calls it with the whole batch.

    engine_spec: an optional numerics override for the run, resolved
    against the model's engine on the sharder's mesh
    (core.numerics.resolve_engine)."""
    if engine_spec is not None:
        model = Model(model.cfg, resolve_engine(
            engine_spec, base=model.eng,
            mesh=None if sharder is None else sharder.mesh),
            device=model.device)
    cfg = model.cfg
    opt_cfg = opt_cfg or AdamWConfig()

    def accumulated(params, batch, prepare):
        return _accumulated(model, params, batch, prepare, microbatches)

    def on_device(batch):
        return {k: torch.as_tensor(v, device=model.device)
                for k, v in batch.items()}

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = accumulated(
            params, on_device(batch), lambda p: cast_params(p, cfg))

        ef = state["ef"]
        if compress_grads:
            grads, ef = ef_compress_tree(grads, ef)

        lr_scale = cosine_schedule(state["opt"]["step"], total=schedule_total)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state["opt"], params, lr_scale)
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return {"params": new_params, "opt": new_opt, "ef": ef}, metrics

    if sharder is None:
        return train_step

    mesh = sharder.mesh
    # each param's spec, in flattened order (the shapes of a meta init)
    shapes = Model(cfg, device="meta").init(0)
    specs = spec_leaves(sharder.param_specs(shapes), shapes)

    def sharded_step(state, batch):
        from torch.distributed.tensor import DTensor

        def local(t):
            return t.to_local()

        def rest(t, like):
            return DTensor.from_local(t, like.device_mesh, like.placements,
                                      run_check=False, shape=like.shape,
                                      stride=like.stride())

        dt_params = state["params"]
        params = tree_map(local, dt_params)
        leaves, treedef = tree_flatten(params)
        # the cast on this rank's shards, then the gather
        whole = tree_unflatten(treedef, [
            gather_dims(t, spec, mesh) for t, spec in zip(
                flatten_like(cast_params(params, cfg), treedef), specs)])
        # this rank's rows: its block along the axes the batch is split
        # over (the whole batch where they have size 1)
        bspecs = sharder.batch_specs(batch)
        rows = {k: shard_dims(v, bspecs[k], mesh)
                for k, v in on_device(batch).items()}
        loss, metrics, grads = accumulated(whole, rows, lambda p: p)
        # gradients of the cast leaves come in the compute dtype: the
        # master's dtype is where the single-device cast's backward puts
        # them
        full = [g.to(p.dtype) for g, p in zip(
            flatten_like(grads, treedef), leaves)]
        bax = sharder.batch_spec()[0]
        bax = (bax,) if isinstance(bax, str) else tuple(bax or ())
        n = 1
        scalars = [v.clone() for v in (loss, metrics["loss"], metrics["aux"])]
        for a in bax:
            n *= sharder.shape[a]
            for t in full + scalars:
                all_reduce_sum(t, mesh, a)
        if n > 1:
            div = torch.tensor(float(n), device=model.device)
            full = [g / div for g in full]
            loss, loss_m, aux = (v / div for v in scalars)
            metrics = {**metrics, "loss": loss_m, "aux": aux,
                       "ppl_proxy": torch.exp(torch.clamp(loss_m, max=20.0))}
        grads = tree_unflatten(treedef, full)

        ef = state["ef"]
        if compress_grads:
            ef_whole = None if ef is None else tree_map(gather_dtensor, ef)
            grads, ef_whole = ef_compress_tree(grads, ef_whole)
            ef = tree_unflatten(treedef, [
                rest(shard_dims(e, spec, mesh).contiguous(), like)
                for e, spec, like in zip(flatten_like(ef_whole, treedef),
                                         specs, tree_flatten(dt_params)[0])])
        # the norm of the whole gradients, as one device takes it
        gnorm = global_norm(grads)
        g_local = tree_unflatten(treedef, [
            shard_dims(g, spec, mesh) for g, spec in zip(
                flatten_like(grads, treedef), specs)])
        opt = {"m": tree_map(local, state["opt"]["m"]),
               "v": tree_map(local, state["opt"]["v"]),
               "step": local(state["opt"]["step"])}
        lr_scale = cosine_schedule(opt["step"], total=schedule_total)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, g_local, opt, params, lr_scale, grad_norm=gnorm)
        new_state = {
            "params": tree_map(rest, new_params, dt_params),
            "opt": {"m": tree_map(rest, new_opt["m"], dt_params),
                    "v": tree_map(rest, new_opt["v"], dt_params),
                    "step": rest(new_opt["step"], state["opt"]["step"])},
            "ef": ef}
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return new_state, metrics

    return sharded_step


def _split_axes(spec) -> tuple:
    """The mesh axes a spec splits its leaf over."""
    return tuple(a for entry in spec for a in (
        (entry,) if isinstance(entry, str) else tuple(entry or ())))


def _block_norm(blocks, split, mesh) -> torch.Tensor:
    """The global norm of whole gradients from this rank's `blocks`: each
    leaf's f32 sum of squares summed over the axes `split` gives it (the
    axes its spec splits it over; a replicated leaf is counted once), one
    all-reduce a set of axes and axis."""
    by_axes: Dict[tuple, torch.Tensor] = {}
    for t, axes in zip(blocks, split):
        sq = torch.sum(torch.square(t.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    for axes, sq in by_axes.items():
        for a in axes:
            all_reduce_sum(sq, mesh, a)
    return torch.sqrt(sum(by_axes.values()))


def jit_train_step(
    model: Model,
    sharder: Sharder,
    state,
    batch_keys,
    *,
    opt_cfg: Optional[AdamWConfig] = None,
    microbatches: int = 1,
    compress_grads: bool = False,
    schedule_total: int = 10_000,
    engine_spec: Optional[EngineSpec] = None,
):
    """The partitioned train step one rank runs (the reference's
    `jit_train_step`): train_step(state, batch) -> (state, metrics), the
    state this rank's blocks at `train_state_specs` (DTensors, as
    `distribute_state` or `init_train_state(model, sharder=)` give them;
    their shapes are checked here), `batch` its rows at
    `sharder.batch_specs(batch_keys)`; the metrics `build_train_step`'s,
    the same on every rank. The state is donated, as the reference's
    `jit_train_step` donates it: its blocks are updated in place and the
    returned state holds the same storage. The module docstring says what
    a step does.
    `train_step.grads(state, batch)` gives (loss, metrics, this rank's
    gradient blocks after the sums over the batch axes and the divide),
    what the update is taken from before compression."""
    from torch.distributed.tensor import DTensor
    if engine_spec is not None:
        model = Model(model.cfg, resolve_engine(
            engine_spec, base=model.eng, mesh=sharder.mesh),
            device=model.device)
    part = _partition(model, sharder)
    cfg = model.cfg
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = sharder.mesh
    shapes = Model(cfg, device="meta").init(0)
    split = [_split_axes(spec) for spec in spec_leaves(
        sharder.param_specs(shapes), shapes)]
    bax = _split_axes(sharder.batch_spec()[:1])
    # each leaf's gradient is summed over the batch axes its spec does not
    # split: a leaf split over `data` had its gradient reduce-scattered
    # over `data` in the backward (`Partition.whole_over_data`)
    over = [tuple(a for a in bax if a not in axes) for axes in split]
    n_rows = math.prod(sharder.shape[a] for a in bax)
    allowed = {"tokens", "mask"}
    if cfg.family in MEMORY_KEYS:
        allowed.add(MEMORY_KEYS[cfg.family])
    if set(batch_keys) - allowed:
        raise ValueError(f"a partitioned train step of {cfg.name} takes "
                         f"{sorted(allowed)}, got {list(batch_keys)}")
    _check_blocks(model, sharder, tree_map(_local, state["params"]))

    def grads(state, batch):
        params = tree_map(_local, state["params"])
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, metrics, g = _accumulated(
            model, params, batch, lambda p: cast_params(p, cfg),
            microbatches, part)
        flat = [t.to(torch.float32) for t in tree_flatten(g)[0]]
        for t, axes in zip(flat, over):
            # one leaf at a time: a bucket of them would be a tensor larger
            # than any leaf's block
            for a in axes:
                all_reduce_sum(t, mesh, a)
        scalars = torch.stack([loss, metrics["loss"], metrics["aux"]])
        for a in bax:
            all_reduce_sum(scalars, mesh, a)
        if n_rows > 1:
            div = torch.tensor(float(n_rows), device=model.device)
            flat = [t / div for t in flat]
            scalars = scalars / div
            loss = scalars[0]
            metrics = {**metrics, "loss": scalars[1], "aux": scalars[2],
                       "ppl_proxy": torch.exp(torch.clamp(scalars[1],
                                                          max=20.0))}
        leaves, treedef = tree_flatten(params)
        return loss, metrics, tree_unflatten(treedef, [
            t.to(p.dtype) for t, p in zip(flat, leaves)])

    def train_step(state, batch):
        loss, metrics, g = grads(state, batch)
        local = tree_map(_local, {"params": state["params"],
                                  "opt": state["opt"]})
        ef = state["ef"]
        if compress_grads:
            g, ef = ef_compress_tree(
                g, None if ef is None else tree_map(_local, ef),
                reduce_max=[_max_over(axes) for axes in split])
        blocks = tree_flatten(g)[0]
        del g
        gnorm = _block_norm(blocks, split, mesh)
        step = local["opt"]["step"]
        lr_scale = cosine_schedule(step, total=schedule_total)
        # the state is donated, as the reference's jit donates it: each
        # leaf's params, m and v are overwritten one leaf at a time (AdamW
        # is elementwise), so the step never holds two states
        for i, (p, m, v) in enumerate(zip(*(tree_flatten(t)[0] for t in (
                local["params"], local["opt"]["m"], local["opt"]["v"])))):
            new_p, new_opt, opt_metrics = adamw_update(
                opt_cfg, [blocks[i]], {"m": [m], "v": [v], "step": step},
                [p], lr_scale, grad_norm=gnorm)
            blocks[i] = None
            for old, new in ((p, new_p[0]), (m, new_opt["m"][0]),
                             (v, new_opt["v"][0])):
                old.copy_(new)
        step.copy_(new_opt["step"])
        new = {**local, "ef": ef}
        if isinstance(tree_flatten(state["params"])[0][0], DTensor):
            new = _at_rest(sharder, new, shapes)
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return new, metrics

    def _max_over(axes):
        def reduce(amax):
            for a in axes:
                all_reduce_max(amax, mesh, a)
            return amax
        return reduce

    train_step.grads = grads
    return train_step


def _local(t):
    """A DTensor's local block; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def build_prefill_step(model: Model):
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill


def build_decode_step(model: Model):
    def decode(params, token, pos, cache, memory=None):
        return model.decode_step(params, token, pos, cache, memory)
    return decode


# ---------------------------------------------------------------- serving
# The batch key of each family's frontend embeddings (B, M, d_model).
MEMORY_KEYS = {"encdec": "frames", "vlm": "patches"}


def _serve_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a leaf is served in: bf16 for an f32 leaf of 2 or more
    dims (f32 masters are a training artifact), its own otherwise (the
    reference's `_serve_params` rule)."""
    return torch.bfloat16 if (t.dtype == torch.float32 and t.ndim >= 2) \
        else t.dtype


def serve_params(params):
    """Every leaf of `params` in its serve dtype (`_serve_dtype`)."""
    return tree_map(lambda p: p.to(_serve_dtype(p)), params)


def block_shape(shape, spec, sizes) -> tuple:
    """The shape of one rank's block of a `shape` leaf under `spec` on a
    mesh of axis `sizes` (an axis name -> size dict)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else tuple(entry or ()):
            out[d] //= sizes[a]
    return tuple(out)


def param_blocks(params, sharder: Sharder):
    """This rank's block of every leaf of whole `params` under the
    sharder's param specs, each a copy of its own (nothing whole kept)."""
    specs = spec_leaves(sharder.param_specs(params), params)
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        shard_dims(t, spec, sharder.mesh).clone()
        for t, spec in zip(leaves, specs)])


def init_serve_params(model: Model, sharder: Optional[Sharder] = None,
                      seed: int = 0):
    """`param_blocks(serve_params(model.init(seed)), sharder)` (the whole
    serve params without a sharder) drawn leaf by leaf: each whole leaf
    is cut to this rank's block in the serve dtype and freed before the
    next draw, so a rank's largest transient is one whole f32 leaf (an
    embedding table, or one stack of every expert's wg, wu or wd) and no
    whole model exists on it."""
    def keep(path, t):
        dtype = _serve_dtype(t)
        if sharder is not None:
            t = shard_dims(t, sharder.param_spec(path, tuple(t.shape)),
                           sharder.mesh)
        return t.to(dtype, copy=True)
    return model.init(seed, keep=keep)


def _serve_blocks(cfg: ModelConfig, sharder: Sharder) -> Dict[str, tuple]:
    """{path: (this rank's block shape, the serve dtype)} of every param
    leaf, from a meta init and the specs alone."""
    sizes = mesh_shape(sharder.mesh)
    return {path: (block_shape(t.shape, sharder.param_spec(
        path, tuple(t.shape)), sizes), _serve_dtype(t))
        for path, t in path_leaves(Model(cfg, device="meta").init(0))}


def serve_block_bytes(cfg: ModelConfig, sharder: Sharder) -> int:
    """The bytes of this rank's serve blocks (`init_serve_params`), from
    the shapes and the specs alone."""
    return sum(math.prod(shape) * dtype.itemsize
               for shape, dtype in _serve_blocks(cfg, sharder).values())


def init_serve_cache(model: Model, sharder: Sharder, batch: int,
                     max_len: int):
    """This rank's block of `model.init_cache(batch, max_len)` (contiguous)
    under the sharder's cache specs, zeros, made without the whole."""
    whole = Model(model.cfg, device="meta").init_cache(batch, max_len)
    sizes = mesh_shape(sharder.mesh)
    leaves, treedef = tree_flatten(whole)
    return tree_unflatten(treedef, [
        torch.zeros(block_shape(t.shape, sharder.cache_spec(path, tuple(
            t.shape)), sizes), dtype=t.dtype, device=model.device)
        for (path, t) in path_leaves(whole)])


def _partition(model: Model, sharder: Sharder) -> Optional[Partition]:
    """The partition context of `model`'s serve steps on the sharder's
    mesh: None where the Sharder replicates every weight (the SSM family:
    the rank runs the whole path on its rows)."""
    if model.eng.mesh is not None and model.eng.shard is not None:
        raise ValueError("a partitioned step runs each GEMM on this rank's "
                         "blocks: its engine shards nothing itself "
                         f"(shard={model.eng.shard!r})")
    return None if sharder.replicated else Partition(sharder)


def _check_blocks(model: Model, sharder: Sharder, params) -> None:
    """Raise unless every leaf of `params` has the shape of this rank's
    block under the sharder's param specs."""
    blocks = _serve_blocks(model.cfg, sharder)
    got = path_leaves(params)
    if [p for p, _ in got] != list(blocks):
        raise ValueError("the params do not have the model's leaves")
    for path, t in got:
        if tuple(t.shape) != blocks[path][0]:
            raise ValueError(f"{path} is {tuple(t.shape)}, this rank's "
                             f"block is {blocks[path][0]}")


def jit_prefill_step(model: Model, sharder: Sharder, params, batch_keys,
                     cache):
    """The partitioned prefill one rank runs (the reference's
    `jit_prefill_step`): prefill(params, batch, cache) -> (logits, cache,
    memory), `params` this rank's blocks at `sharder.param_specs` (they are
    checked here), `batch` its rows at `sharder.batch_specs(batch_keys)`
    (tokens, an optional mask and, for the enc-dec and VLM families, the
    frontend's "frames" or "patches"), `cache` its block at
    `sharder.cache_specs` (`init_serve_cache`), updated in place; the
    logits at P(batch, vocab_axis()): (B_rank, vocab_padded / model), or
    (B_rank, vocab_padded) where the weights are replicated; the memory
    the cross-attention layers read at P(batch, None, None), this rank's
    rows whole over `model` (None for the other families). `last_index=`
    (each lane's last prompt position, `Model.prefill`'s) serves
    right-padded prompts. A MoE layer runs the experts of this rank's
    blocks, split by expert or by d_ff as the specs of its leaves give
    (`models/moe.py`); a sliding-window layer keeps its block of the ring
    (`models/layers.py`); an RG-LRU layer its channels of the state
    (`models/recurrent.py`); the encoder and the cross-attention layers
    their heads' columns of wq, wk and wv (`models/layers.py`)."""
    part = _partition(model, sharder)
    _check_blocks(model, sharder, params)
    allowed = {"tokens", "mask"}
    if model.cfg.family in MEMORY_KEYS:
        allowed.add(MEMORY_KEYS[model.cfg.family])
    if set(batch_keys) - allowed:
        raise ValueError(f"a partitioned prefill of {model.cfg.name} takes "
                         f"{sorted(allowed)}, got {batch_keys}")

    def prefill(params, batch, cache, last_index=None):
        return model.prefill(params, batch, cache, last_index=last_index,
                             part=part)
    return prefill


def jit_decode_step(model: Model, sharder: Sharder, params, cache, *,
                    has_memory: bool):
    """The partitioned decode step one rank runs (the reference's
    `jit_decode_step`): decode(params, token, pos, cache) -> (logits,
    cache), or with `has_memory` (the enc-dec and VLM families, and only
    they) decode(params, token, pos, cache, memory), the memory the
    prefill returned; token, pos and the memory this rank's rows, the
    rest as `jit_prefill_step`'s."""
    part = _partition(model, sharder)
    _check_blocks(model, sharder, params)
    wants = model.cfg.family in MEMORY_KEYS
    if has_memory != wants:
        raise ValueError(f"{model.cfg.name} ({model.cfg.family}) decodes "
                         f"{'with' if wants else 'without'} a memory, got "
                         f"has_memory={has_memory}")

    if has_memory:
        def decode(params, token, pos, cache, memory):
            return model.decode_step(params, token, pos, cache, memory,
                                     part=part)
    else:
        def decode(params, token, pos, cache):
            return model.decode_step(params, token, pos, cache, part=part)
    return decode
