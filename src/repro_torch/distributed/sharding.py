"""Sharding rules: param, activation and cache specs per profile (port of
`repro/distributed/sharding.py`).

A spec is a tuple with one entry a dim: None (replicated), a mesh axis
name, or a tuple of names (the dim split over several axes, outer axis
first). On a real mesh (a DeviceMesh) `placements(spec)` turns it into
DTensor placements; the rules themselves need the axis names and sizes
alone, so they run on an AbstractMesh too.

Profiles (cfg.sharding_profile):
  tp       - weights sharded over the `model` axis only (Megatron TP);
             batch over ('pod', 'data').
  fsdp_tp  - the non-TP weight axis sharded over `data` too (ZeRO-3), for
             the >= 30B configs (f32 masters + Adam state, 12 B a param).

MoE (cfg.moe_sharding):
  ep - expert axis over `model` (when E % model == 0);
  tp - d_ff over `model` inside each expert.

Small attention-free models (mamba2) replicate the weights and spread the
batch over BOTH axes.

The rules key on a leaf's name and its parent and right-align to the
leaf's dims (`pad`), so they apply unchanged to the reference's stacked
`blocks/scan/<slot>/...` leaves and to the port's per-layer
`layers/<i>/...` ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.launch.mesh import AbstractMesh, mesh_shape
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["Sharder", "NamedSharding", "P", "gemm_partition_specs",
           "path_leaves", "spec_leaves"]

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A DeviceMesh and DTensor placements on it: where a whole tensor
    goes (CheckpointManager.restore's `shardings` leaves)."""
    mesh: Any
    placements: tuple


def gemm_partition_specs(partition: str, axis: str = "model"):
    """((x_spec, w_spec), out_spec) for one mesh-sharded olm GEMM. The
    table lives beside the kernel front-end
    (kernels/online_dot/matmul_sharded); this is the model layer's entry
    point to it.

      m - x rows over `axis`, w replicated, output rows sharded
          (bit-identical per shard to one device);
      n - w columns over `axis`, output columns sharded (bit-identical);
      k - contraction co-sharded, f32 partials summed, output replicated
          (olm_error_bound holds; the order of the sum differs).
    """
    from repro_torch.kernels.online_dot.matmul_sharded import (
        gemm_partition_specs as _specs)
    return _specs(partition, axis)


def _path_walk(node, path, out) -> None:
    # a module function, not a closure: see repro_torch/tree.py
    if isinstance(node, dict):
        for k in sorted(node):
            _path_walk(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _path_walk(v, path + (str(i),), out)
    elif node is not None:
        out.append(("/".join(path), node))


def path_leaves(tree) -> list:
    """[(path, leaf)] of a tree in flattened order; a path joins dict keys
    and list indices with "/", as the reference's `_path_str`."""
    out: list = []
    _path_walk(tree, (), out)
    return out


def _spec_walk(node, spec, out) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _spec_walk(node[k], spec[k], out)
    elif isinstance(node, (list, tuple)):
        for n, s in zip(node, spec):
            _spec_walk(n, s, out)
    elif node is not None:
        out.append(spec)


def spec_leaves(specs, like) -> list:
    """The spec of each leaf of `like`, in flattened order, from `specs`:
    a tree of like's structure with a spec in place of each leaf (a spec
    is a tuple, so such a tree cannot be flattened on its own)."""
    out: list = []
    _spec_walk(like, specs, out)
    return out


def _spec_tree(tree, fn) -> Any:
    _, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(path, leaf.shape)
                                    for path, leaf in path_leaves(tree)])


def P(*dims) -> Spec:
    """A spec of `dims`, normalized as jax's PartitionSpec normalizes: a
    tuple of one axis is the axis, an empty tuple is None."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                 else None if d == () else d for d in dims)


def _pad(shape: Sequence[int], dims) -> Spec:
    return P(*([None] * (len(shape) - len(dims)) + list(dims)))


class Sharder:
    def __init__(self, mesh, cfg: ModelConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.shape = mesh_shape(mesh)
        self.dp: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in self.shape)
        self.model_size = self.shape["model"]
        self.data_size = math.prod(self.shape[a] for a in self.dp)
        self.fsdp = cfg.sharding_profile == "fsdp_tp"
        # mamba2-style tiny models: replicate weights, batch over all axes
        self.replicated = cfg.family == "ssm"
        self._batch_ax: Optional[Tuple[str, ...]] = None

    def set_batch(self, global_batch: int) -> None:
        """Pick the batch-sharding axes as the longest prefix of the DP
        axes (+ model for replicated-weight models) that divides the
        global batch: small batches fall back to fewer axes."""
        axes = self.dp + (("model",) if self.replicated else ())
        chosen: Tuple[str, ...] = ()
        size = 1
        for a in axes:
            s = self.shape[a]
            if global_batch % (size * s) == 0:
                chosen = chosen + (a,)
                size *= s
        self._batch_ax = chosen

    # -------------- helpers --------------
    def _fs(self) -> Optional[str]:
        """The FSDP axis for the non-TP weight dimension ('data' or None).
        Only 'data' (not 'pod'), so a pod holds a full copy."""
        return "data" if (self.fsdp and "data" in self.shape) else None

    def placements(self, spec: Spec) -> tuple:
        """The DTensor placements of `spec` on this sharder's DeviceMesh:
        Shard(d) on each mesh dim that shards tensor dim d (a dim over two
        axes is Shard(d) on both, outer axis first), Replicate() on the
        others."""
        if isinstance(self.mesh, AbstractMesh):
            import torch.distributed as dist
            raise self.mesh.unplaced(dist.get_world_size()
                                     if dist.is_initialized() else 1)
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if [names.index(a) for a in axes] != sorted(
                    names.index(a) for a in axes):
                raise ValueError(f"spec {spec} splits dim {d} over {axes}, "
                                 f"not in the mesh's order {names}")
            for a in axes:
                out[names.index(a)] = Shard(d)
        return tuple(out)

    # -------------- params --------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        cfg = self.cfg
        fs = self._fs()

        def pad(dims):
            return _pad(shape, dims)

        if self.replicated:
            return (None,) * len(shape)
        leaf = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        # embeddings / unembedding: vocab over model, d over fsdp axis
        if leaf == "table":
            return pad(["model", fs])
        # router: small, replicated
        if leaf == "router":
            return pad([None, None])
        # MoE experts (E, d, f) / (E, f, d), told apart from the dense MLP
        # (the same leaf names) by the path
        if parent == "moe" or "/moe/" in path:
            if cfg.moe_sharding == "ep" and cfg.n_experts % self.model_size == 0:
                return pad(["model", fs, None])
            return pad([None, fs, "model"]) if leaf in ("wg", "wu") else \
                pad([None, "model", fs])
        # attention projections
        if leaf in ("wq", "wk", "wv"):
            return pad([fs, "model"])
        if leaf == "wo" and parent in ("attn", "cross", "rec"):
            return pad(["model", fs])
        if leaf in ("bq", "bk", "bv"):
            return pad(["model"])
        # dense MLP
        if leaf in ("wg", "wu"):
            return pad([fs, "model"])
        if leaf == "wd":
            return pad(["model", fs])
        # RG-LRU
        if leaf in ("wx", "wy"):
            return pad([fs, "model"])
        if leaf in ("wa", "wi"):
            return pad([None, "model"])
        if leaf in ("ba", "bi", "lam"):
            return pad(["model"])
        if leaf == "conv":
            return pad([None, "model"])
        # SSD (only reached when not `replicated`, e.g. a scaled-up ssm)
        if leaf == "win":
            return pad([fs, "model"])
        if leaf == "wout":
            return pad(["model", fs])
        if leaf in ("a_log", "dt_bias", "d_skip", "norm"):
            return pad([None])
        # norms and anything residual-width
        if leaf == "scale":
            return pad([None])
        return (None,) * len(shape)

    def param_specs(self, params) -> Any:
        return _spec_tree(params, self.param_spec)

    # -------------- activations / batch --------------
    def batch_spec(self) -> Spec:
        """tokens (B, S): batch over the DP axes (and model too for the
        replicated tiny models, every rank doing DP)."""
        if self._batch_ax is not None:
            return P(self._batch_ax or None, None)
        if self.replicated:
            return P(self.dp + ("model",), None)
        return P(self.dp, None)

    def batch_specs(self, batch_keys) -> Dict[str, Spec]:
        out = {}
        for k in batch_keys:
            if k in ("tokens", "mask"):
                out[k] = self.batch_spec()
            else:  # frontend embeddings (B, M, d)
                out[k] = P(self.batch_spec()[0], None, None)
        return out

    def activation_spec(self, *, seq_sharded: bool = False) -> Spec:
        """Residual stream (B, S, d)."""
        bd = self.batch_spec()[0]
        if seq_sharded:
            return P(bd, "model", None)
        return P(bd, None, None)

    def vocab_axis(self) -> Optional[str]:
        """Axis for the vocab dim of logits; None when 'model' already
        carries the batch (replicated-weight profile)."""
        bd = self.batch_spec()[0]
        names = (bd,) if isinstance(bd, str) else tuple(bd or ())
        return None if (self.replicated or "model" in names) else "model"

    def logits_spec(self) -> Spec:
        return P(self.batch_spec()[0], None, self.vocab_axis())

    # -------------- caches --------------
    def cache_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """KV / recurrent cache leaves: kv (..., B, T, Hkv, D); rec h
        (..., B, w); ssm h (..., B, H, P, N)."""
        bd = self.batch_spec()[0]
        leaf = path.split("/")[-1]

        def pad(dims):
            return _pad(shape, dims)

        if leaf == "len":
            return pad([])
        if self.replicated:
            if leaf in ("k", "v"):
                return pad([bd, None, None, None])
            if leaf == "h":
                return pad([bd, None, None, None]) if len(shape) >= 4 \
                    else pad([bd, None])
            if leaf == "conv":
                return pad([bd, None, None])
        if leaf in ("k", "v"):
            # kv heads over `model` where they divide it, else the cache
            # length
            if self.cfg.n_kv_heads % self.model_size == 0:
                return pad([bd, None, "model", None])
            return pad([bd, "model", None, None])
        if leaf == "h":
            if len(shape) >= 4:  # ssm state (..., B, H, P, N)
                return pad([bd, None, None, None])
            return pad([bd, "model"])  # rg-lru (..., B, w)
        if leaf == "conv":
            return pad([bd, None, "model"])
        return (None,) * len(shape)

    def cache_specs(self, cache) -> Any:
        return _spec_tree(cache, self.cache_spec)
