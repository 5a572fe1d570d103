"""Carry a parameter tree of the JAX reference model over to the port.

`params_from_jax(tree, cfg)` takes the pytree of the reference's
`Model.init` with its leaves as numpy arrays (`jax.tree.map(np.asarray,
params)`) and returns the port's params: the stacked `blocks/scan` groups
(one leading group axis per pattern slot) and the `blocks/rem` remainder
layers unrolled into the port's per-layer list, in execution order. Every
leaf of a layer comes across, the attention biases `bq`/`bk`/`bv` of a
`qkv_bias` config with them; a tied tree (`tie_embeddings`) has no
`unembed` table. An enc-dec tree's `encoder` (its stacked layers and final
norm) comes across as the port's `encoder` {"layers", "final_norm"}; the
`cross` attention and `norm_x` leaves of the cross-attention layers come
with their layers. Leaves come across in `cfg.param_dtype`, except those
the reference keeps in f32 whatever `param_dtype` is (the RG-LRU's `lam`,
the SSD's `a_log`, `dt_bias` and `d_skip`, the MoE `router`). With both
packages on the same weights, the tests hold the port against the
reference.

With `sharder=` it returns one rank's blocks instead: each leaf cut to
this rank's block under the Sharder's param specs (what the partitioned
serve steps of `distributed/train.py` take), the whole leaf dropped.
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


# leaves the reference initializes in f32 whatever param_dtype is
_F32_LEAVES = frozenset({"lam", "a_log", "dt_bias", "d_skip", "router"})


def _tree(node, dtype, device):
    if isinstance(node, dict):
        return {k: (_tensor(v, torch.float32, device) if k in _F32_LEAVES
                    else _tree(v, dtype, device)) for k, v in node.items()}
    return _tensor(node, dtype, device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device=None, sharder=None) -> Dict[str, Any]:
    """The port's params for `cfg` from a reference parameter tree of
    numpy leaves, on `device` (CUDA unless given); this rank's blocks of
    them under `sharder`'s param specs where one is given."""
    dev = resolve_device(device)
    dt = cfg.pdtype
    layers = _layers(tree["blocks"], cfg.block_pattern, cfg.n_layers, dt, dev)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    if ("encoder" in tree) != bool(cfg.n_enc_layers):
        raise ValueError(f"tree {'has' if 'encoder' in tree else 'lacks'} "
                         f"an encoder, config {cfg.name} has n_enc_layers="
                         f"{cfg.n_enc_layers}")
    if ("unembed" in tree) == cfg.tie_embeddings:
        raise ValueError(f"tree {'has' if 'unembed' in tree else 'lacks'} "
                         f"an unembed table, config {cfg.name} has "
                         f"tie_embeddings={cfg.tie_embeddings}")
    params = {"embed": _tree(tree["embed"], dt, dev),
              "layers": layers,
              "final_norm": _tree(tree["final_norm"], dt, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = _tree(tree["unembed"], dt, dev)
    if cfg.n_enc_layers:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": _layers(enc["blocks"], ("attn",), cfg.n_enc_layers,
                              dt, dev),
            "final_norm": _tree(enc["final_norm"], dt, dev)}
    if sharder is not None:
        from repro_torch.distributed.train import param_blocks
        params = param_blocks(params, sharder)
    return params


def _layers(blocks, pattern, n_layers: int, dt, dev) -> List[Dict[str, Any]]:
    """A stack's layers in execution order: the scanned groups (one
    leading group axis per pattern slot), then the remainder layers."""
    layers = [_tree(_slice(blocks["scan"][s], g), dt, dev)
              for g in range(n_layers // len(pattern))
              for s in range(len(pattern))]
    return layers + [_tree(rem, dt, dev) for rem in blocks["rem"]]


def _slice(node, g: int):
    """Group g of a stacked (G, ...) subtree."""
    if isinstance(node, dict):
        return {k: _slice(v, g) for k, v in node.items()}
    return np.asarray(node)[g]
