"""Carry a parameter tree of the JAX reference model over to the port.

`params_from_jax(tree, cfg)` takes the pytree of the reference's
`Model.init` with its leaves as numpy arrays (`jax.tree.map(np.asarray,
params)`) and returns the port's params: the stacked `blocks/scan` groups
(one leading group axis per pattern slot) and the `blocks/rem` remainder
layers unrolled into the port's per-layer list, in execution order. Every
leaf of a layer comes across, the attention biases `bq`/`bk`/`bv` of a
`qkv_bias` config with them; a tied tree (`tie_embeddings`) has no
`unembed` table. With both packages on the same weights, the tests hold
the port against the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import resolve_device

__all__ = ["params_from_jax"]


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def _tree(node, dtype, device):
    if isinstance(node, dict):
        return {k: _tree(v, dtype, device) for k, v in node.items()}
    return _tensor(node, dtype, device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device=None) -> Dict[str, Any]:
    """The port's params for `cfg` from a reference parameter tree of
    numpy leaves, on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    dt = cfg.pdtype
    pattern = cfg.block_pattern
    scan = tree["blocks"]["scan"]
    groups = cfg.n_layers // len(pattern)
    layers: List[Dict[str, Any]] = []
    for g in range(groups):
        for s in range(len(pattern)):
            layer = _slice(scan[s], g)
            layers.append(_tree(layer, dt, dev))
    for rem in tree["blocks"]["rem"]:
        layers.append(_tree(rem, dt, dev))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    if ("unembed" in tree) == cfg.tie_embeddings:
        raise ValueError(f"tree {'has' if 'unembed' in tree else 'lacks'} "
                         f"an unembed table, config {cfg.name} has "
                         f"tie_embeddings={cfg.tie_embeddings}")
    params = {"embed": _tree(tree["embed"], dt, dev),
              "layers": layers,
              "final_norm": _tree(tree["final_norm"], dt, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = _tree(tree["unembed"], dt, dev)
    return params


def _slice(node, g: int):
    """Group g of a stacked (G, ...) subtree."""
    if isinstance(node, dict):
        return {k: _slice(v, g) for k, v in node.items()}
    return np.asarray(node)[g]
