"""The train, prefill and decode step builders (port of
`repro/distributed/train.py`).

build_train_step: loss + grad + AdamW update, with
  * gradient accumulation over microbatches, in the reference's strided
    split: microbatch k holds rows k, k + mb, k + 2 mb, ... of the batch
    (which rows share a microbatch decides the MoE capacity drops and the
    f32 sums), its gradients summed in order and divided by mb;
  * optional int8 error-feedback gradient compression (compress_grads);
  * mixed precision: every f32 leaf the reference casts goes to the
    compute dtype before the forward (`cast_params`), and the gradients
    reach the f32 masters through the cast.

With a `Sharder` it stands in for the reference's `jit_train_step`: the
state rests as DTensors with the placements of `train_state_specs`
(`distribute_state`), and each step
  * casts this rank's param shards to the compute dtype, then gathers
    them whole (the cast before the gather, as `_cast_params` pins it);
  * runs the forward and backward on this rank's rows of the batch (its
    block along the axes `batch_spec` splits the batch over);
  * sums the gradients over those axes and divides by their size, as
    the microbatches divide;
  * compresses (compress_grads) and takes the global norm on the whole
    gradients, then runs AdamW on this rank's shards.
An `engine_spec` with `shard=` runs every olm GEMM of the step through the
mesh-sharded front-end on the sharder's mesh. The collectives are the
c10d calls of `distributed.collectives`. The reference's
`with_sharding_constraint` hints have no eager counterpart.

A digit-mode engine (olm*, tpmm*) runs its kernel on every GEMM of the
forward, and its derivative is zero, as the reference's
(core/numerics.py `_DigitDot`).

The serve steps keep one of two layouts:
  * whole: `build_prefill_step` / `build_decode_step` run `Model.prefill`
    / `decode_step` on whole params and cache, as on one device (every
    rank of a mesh holds the whole weights);
  * partitioned: `jit_prefill_step` / `jit_decode_step`, the reference's
    names and arguments, run them on this rank's blocks at the Sharder's
    `param_specs`, `cache_specs` and `batch_specs` under a `Partition`
    (`partition.py`), the logits vocab-sharded at P(batch, vocab_axis()).
    No rank holds a whole weight of a `model`-sharded leaf or more of the
    cache than its block; `init_serve_params` draws the blocks without a
    whole model ever existing on the rank. The dense, MoE (sliding-window
    rings too), recurrent and cross-attention families run under the
    partition context (the enc-dec family's encoder too: the prefill
    returns the memory as this rank's rows, whole over `model`, and the
    decode takes it back); the SSM family, whose weights the Sharder
    replicates, runs the whole path on the rank's rows of the batch and
    cache, with no collective, as the reference's compiled program has
    none.
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
from .collectives import (all_reduce_sum, gather_dims, gather_dtensor,
                          shard_dims)
from .partition import Partition
from .sharding import NamedSharding, Sharder, path_leaves, spec_leaves

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "jit_prefill_step", "jit_decode_step", "MEMORY_KEYS",
           "serve_params", "init_serve_params", "init_serve_cache",
           "param_blocks", "block_shape", "serve_block_bytes",
           "init_train_state", "cast_params", "train_state_specs",
           "distribute_state", "gather_state", "state_shardings"]


def init_train_state(model: Model, seed: int = 0) -> Dict[str, Any]:
    params = model.init(seed)
    return {
        "params": params,
        "opt": adamw_init(params),
        "ef": None,  # error-feedback state, created on first compressed step
    }


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

    def grads_of(params, batch, prepare):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = lm_loss(
            model, prepare(tree_unflatten(treedef, live)), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        if missing := [i for i, g in enumerate(grads) if g is None]:
            raise RuntimeError(f"leaves {missing} of the params got no "
                               "gradient: the loss does not reach them")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def accumulated(params, batch, prepare):
        """(loss, metrics, f32-summed grads / mb) over the microbatches;
        the gradient of a leaf comes in the leaf's dtype."""
        if microbatches == 1:
            return grads_of(params, batch, prepare)
        B = next(iter(batch.values())).shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for k in range(microbatches):
            # the reference's (B, ...) -> (B/mb, mb, ...) reshape,
            # swapped: microbatch k is rows k, k + mb, ...
            loss, metrics, g = grads_of(
                params, {n: v[k::microbatches] for n, v in batch.items()},
                prepare)
            grads = tree_map(torch.add, grads, g)
            loss_sum = loss_sum + loss
        mb = torch.tensor(float(microbatches), device=model.device)
        return loss_sum / mb, metrics, tree_map(lambda g: g / mb, grads)

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
