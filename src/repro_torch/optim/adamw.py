"""AdamW with decoupled weight decay and global-norm clipping (port of
`repro/optim/adamw.py`).

The optimizer state is a tree shaped like the params (m and v in f32) and
a 0-d int32 step. The arithmetic and its order are the reference's: the
gradient is scaled by the clip factor, then m, v, their bias corrections
(an f32 power of the step) and the decoupled decay of every leaf, 1-D
leaves and leaves whose gradient is zero included. `torch.optim.AdamW`
decays before the moment update and skips parameters without a gradient,
so it gives other bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import (flatten_like, tree_flatten, tree_leaves,
                               tree_map, tree_unflatten)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in order, of each leaf's f32 sum of
    squares."""
    total = sum(torch.sum(torch.square(leaf.to(torch.float32)))
                for leaf in tree_leaves(tree))
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, lr_scale=1.0,
                 grad_norm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}).
    grad_norm: the global norm to clip by, where `grads` are shards of
    the gradients it was taken on (default: global_norm(grads))."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    dev = gnorm.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    # a Python number over a tensor is its reciprocal times the number in
    # PyTorch: the quotient takes an f32 tensor numerator instead
    scale = torch.clamp(f32(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(f32(cfg.b1), stepf)
    b2c = 1.0 - torch.pow(f32(cfg.b2), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=dev)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m_ = cfg.b1 * m + (1 - cfg.b1) * g
        v_ = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_ / b1c
        vh = v_ / b2c
        pf = p.to(torch.float32)
        pn = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        return pn.to(p.dtype), m_, v_

    flat, treedef = tree_flatten(params)
    gflat, mflat, vflat = (flatten_like(t, treedef) for t in (
        grads, opt_state["m"], opt_state["v"]))
    out = [upd(g, m, v, p) for g, m, v, p in zip(gflat, mflat, vflat, flat)]
    new_p, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in out])
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gnorm, "lr": lr}

