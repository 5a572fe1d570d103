"""The train, prefill and decode step builders on one device (port of
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

The reference's mesh pieces (the sharder, `with_sharding_constraint`,
`jit_*`, `train_state_specs`) wait for the sharded port (ROADMAP
section 1, item 8); an EngineSpec naming a mesh or a shard is refused.
A digit-mode engine (olm*, tpmm*) runs its kernel on every GEMM of the
forward, and its derivative is zero, as the reference's
(core/numerics.py `_DigitDot`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.numerics import EngineSpec, resolve_engine
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, lm_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import ef_compress_tree
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "init_train_state", "cast_params"]


def init_train_state(model: Model, seed: int = 0) -> Dict[str, Any]:
    params = model.init(seed)
    return {
        "params": params,
        "opt": adamw_init(params),
        "ef": None,  # error-feedback state, created on first compressed step
    }


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

    engine_spec: an optional numerics override for the run, resolved
    against the model's engine (core.numerics.resolve_engine)."""
    if engine_spec is not None:
        model = Model(model.cfg, resolve_engine(engine_spec, base=model.eng),
                      device=model.device)
    cfg = model.cfg
    opt_cfg = opt_cfg or AdamWConfig()

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = lm_loss(
            model, cast_params(tree_unflatten(treedef, live), cfg), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        if missing := [i for i, g in enumerate(grads) if g is None]:
            raise RuntimeError(f"leaves {missing} of the params got no "
                               "gradient: the loss does not reach them")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def train_step(state, batch):
        params = state["params"]
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for k in range(microbatches):
                # the reference's (B, ...) -> (B/mb, mb, ...) reshape,
                # swapped: microbatch k is rows k, k + mb, ...
                loss, metrics, g = grads_of(
                    params, {n: v[k::microbatches] for n, v in batch.items()})
                grads = tree_map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            mb = torch.tensor(float(microbatches), device=model.device)
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss_sum / mb
        else:
            loss, metrics, grads = grads_of(params, batch)

        ef = state["ef"]
        if compress_grads:
            grads, ef = ef_compress_tree(grads, ef)

        lr_scale = cosine_schedule(state["opt"]["step"], total=schedule_total)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state["opt"], params, lr_scale)
        metrics = {**metrics, **opt_metrics, "loss_total": loss}
        return {"params": new_params, "opt": new_opt, "ef": ef}, metrics

    return train_step


def build_prefill_step(model: Model):
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill


def build_decode_step(model: Model):
    def decode(params, token, pos, cache, memory=None):
        return model.decode_step(params, token, pos, cache, memory)
    return decode
