"""Roofline terms of the dry run (port of `repro/launch/roofline.py`).

The reference reads FLOPs, bytes and collectives off XLA's compiled HLO
(`hlo_walk`, trip-weighted over its while loops). The port has no HLO:
`walk` runs one step of the port's own code, on meta tensors, under two
dispatch modes, and counts what it does as it runs (a loop is counted
once an iteration, so no trip counts are needed):

  * dot FLOPs: `torch.utils.flop_counter.FlopCounterMode` (mm, bmm,
    addmm, baddbmm, convolution and the sdpa kernels; an einsum reaches
    it as bmm or mm), the set the reference's dot-only walk counts;
  * bytes: each op's input bytes read once and its output bytes written
    once. An op whose every output aliases an input (view, reshape
    without a copy, transpose, expand, narrow, detach) and the `empty`
    family count 0. This is the HBM traffic of the port's eager
    execution on the card, which fuses nothing. The reference instead
    counts the result bytes of the ops a TPU materializes (fusions,
    dots, reductions; an elementwise chain inside a fusion is free), so
    the port's figure is the larger by every elementwise pass;
  * live bytes and their peak: each storage once, however many views
    share it, from the op that makes it until its last tensor dies,
    rounded up to 512 B as the CUDA caching allocator rounds each block
    (so the peak reads against `torch.cuda.max_memory_allocated()`); the
    arguments count from the start and stay live throughout;
  * collective bytes: the per-device result bytes of each all-gather,
    all-reduce and reduce-scatter (the reference's convention), by kind
    and by mesh axis. Every collective of the port is a c10d call of
    `distributed/collectives.py`; the walk sees each as a `c10d` op and
    names its axis by its process group.

Three terms per cell, in seconds, with H100 SXM constants:

    compute    = dot FLOPs / 989e12 FLOP/s
    memory     = walk bytes / 3.35e12 B/s
    collective = sum over mesh axes of that axis's bytes / its link rate

An axis whose ranks share a host of HOST_CARDS cards (host = rank //
HOST_CARDS) runs on NVLink, one that crosses hosts on InfiniBand.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["walk", "collective_bytes", "axis_links", "model_flops",
           "roofline_terms", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW",
           "HOST_CARDS", "ALLOC_ROUND"]

# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 on the tensor cores
# and 3.35 TB/s of HBM3, both at the 700 W power limit
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# the same data sheet: NVLink 4 at 900 GB/s a card, both ways together
NVLINK_BW = 450e9
# NVIDIA DGX H100: one 400 Gb/s InfiniBand NDR port (ConnectX-7) a card
IB_BW = 50e9
# cards that share NVLink in one DGX / HGX H100 host
HOST_CARDS = 8
# the CUDA caching allocator rounds every block up to a multiple of 512 B
ALLOC_ROUND = 512

# c10d op -> the collective it is; its first argument holds the result
_COLLECTIVES = {
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
}

_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}


def _collect(tree, out: list, dtensor: type) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out, dtensor)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out, dtensor)
    elif isinstance(tree, dtensor):
        out.append(tree._local_tensor)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)


def _tensors(tree) -> list:
    """The plain tensors of a tree of dicts, lists and tuples (a DTensor
    stands for its local shard)."""
    from torch.distributed.tensor import DTensor
    out: list = []
    _collect(tree, out, DTensor)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Walk(TorchDispatchMode):
    """Counts the bytes, live storages and collectives of the ops it sees
    (module docstring). `groups` maps a process group's name to its mesh
    axis."""

    def __init__(self, groups: Dict[str, str]):
        super().__init__()
        self.groups = groups
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.collectives: Dict[tuple, list] = {}   # (kind, axis) -> [B, n]
        self._storages: Dict[int, list] = {}       # key -> [bytes, tensors]

    def track(self, t: torch.Tensor) -> None:
        """Count t's storage live (once for all its views) until the last
        tensor tracked on it dies."""
        key = _storage_key(t)
        rec = self._storages.get(key)
        if rec is None:
            n = -(-t.untyped_storage().nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            self._storages[key] = rec = [n, 0]
            self.live += n
            self.peak = max(self.peak, self.live)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._storages[key]

    def live_bytes(self, tensors) -> int:
        """Rounded bytes of the distinct storages of `tensors`."""
        seen = {}
        for t in tensors:
            seen[_storage_key(t)] = -(-t.untyped_storage().nbytes()
                                      // ALLOC_ROUND) * ALLOC_ROUND
        return sum(seen.values())

    def _collective(self, func, args, kwargs) -> None:
        kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
        if kind is None:
            raise NotImplementedError(f"the walk does not count {func}")
        from torch._C._distributed_c10d import ProcessGroup
        group = next(a for a in list(args) + list(kwargs.values())
                     if isinstance(a, torch.ScriptObject)
                     and "ProcessGroup" in str(a._type()))
        gname = ProcessGroup.unbox(group).group_name
        if gname not in self.groups:
            raise KeyError(f"{func} on a process group ({gname}) of no "
                           f"mesh axis the walk knows")
        rec = self.collectives.setdefault((kind, self.groups[gname]), [0, 0])
        rec[0] += sum(_nbytes(t) for t in _tensors(args[0]))
        rec[1] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "c10d":
            self._collective(func, args, kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        mutates = func._schema.is_mutable
        in_keys = {_storage_key(t) for t in ins}
        aliased = not mutates and outs and all(
            _storage_key(t) in in_keys for t in outs)
        if not aliased and func._schema.name.split("::")[-1] not in _EMPTY:
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


def _groups(mesh) -> Dict[str, str]:
    if mesh is None:
        return {}
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def walk(fn: Callable, *args, mesh=None) -> Dict[str, Any]:
    """Run fn(*args) once under the counters and return what one rank did:
    dot FLOPs (`flops`), bytes read and written (`bytes`), the live bytes
    (`bytes_per_device`: argument, output, temp and peak), the raw
    collective counts (`collective_bytes` turns them into the record) and
    the number of ops. `mesh`: the DeviceMesh whose axes name the
    collectives' process groups. Whatever fn returns is dropped."""
    from torch.utils.flop_counter import FlopCounterMode
    w = _Walk(_groups(mesh))
    arg_tensors = _tensors(args)
    for t in arg_tensors:
        w.track(t)
    argument = w.live
    with FlopCounterMode(display=False) as fc, w:
        out = fn(*args)
    arg_keys = {_storage_key(t) for t in arg_tensors}
    output = w.live_bytes(t for t in _tensors(out)
                          if _storage_key(t) not in arg_keys)
    del out
    return {
        "flops": int(fc.get_total_flops()),
        "bytes": int(w.bytes),
        "ops": w.ops,
        "bytes_per_device": {"argument": argument, "output": output,
                             "temp": max(0, w.peak - argument - output),
                             "peak": w.peak},
        "collectives": {f"{k}@{a}": {"kind": k, "axis": a, "bytes": b,
                                     "count": n}
                        for (k, a), (b, n) in sorted(w.collectives.items())},
    }


def axis_links(mesh) -> Dict[str, float]:
    """Mesh axis -> its link rate (B/s) as this rank sees it: NVLink where
    the ranks of its group along the axis share a host of HOST_CARDS
    cards, InfiniBand where they cross hosts."""
    import torch.distributed as dist
    out = {}
    for a in mesh.mesh_dim_names:
        ranks = dist.get_process_group_ranks(mesh.get_group(a))
        hosts = {r // HOST_CARDS for r in ranks}
        out[a] = NVLINK_BW if len(hosts) == 1 else IB_BW
    return out


def collective_bytes(counts: Dict[str, Any], links: Dict[str, float]
                     ) -> Dict[str, Any]:
    """The collectives record from a walk's raw counts (`walk(...)
    ["collectives"]`), in place of the reference's parse of HLO text:
    bytes by kind and by axis, the count, the total, and each axis's
    link rate (`links`, from `axis_links`)."""
    per_kind: Dict[str, float] = {}
    per_axis: Dict[str, float] = {}
    n = 0
    for rec in counts.values():
        per_kind[rec["kind"]] = per_kind.get(rec["kind"], 0) + rec["bytes"]
        per_axis[rec["axis"]] = per_axis.get(rec["axis"], 0) + rec["bytes"]
        n += rec["count"]
    return {"per_kind": per_kind, "per_axis": per_axis, "count": n,
            "total_bytes": float(sum(per_kind.values())),
            "link_bw": dict(links)}


def model_flops(cfg, case) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE) global training FLOPs; forward
    only (2*N*D) for serving kinds."""
    n_params = cfg.param_count()
    if cfg.n_experts:
        dense_share = (n_params - cfg.n_layers * cfg.n_experts * 3
                       * cfg.d_model * cfg.d_ff)
        active = dense_share + (cfg.n_layers * cfg.experts_per_token * 3
                                * cfg.d_model * cfg.d_ff)
    else:
        active = n_params
    tokens = case.global_batch * (case.seq_len if case.kind != "decode"
                                  else 1)
    mult = 6.0 if case.kind == "train" else 2.0
    return mult * active * tokens


def roofline_terms(cost: Dict[str, Any], coll: Dict[str, Any], *,
                   n_chips: int, cfg=None, case=None) -> Dict[str, Any]:
    """Three-term roofline of one rank, all in seconds. `cost`: a walk
    (its `flops` and `bytes`); `coll`: `collective_bytes`'s record, whose
    bytes on each axis move at that axis's link rate."""
    flops = float(cost["flops"])
    byts = float(cost["bytes"])
    coll_s = sum(b / coll["link_bw"][a] for a, b in coll["per_axis"].items())
    terms: Dict[str, Any] = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": byts / HBM_BW,
        "collective_s": coll_s,
        "n_chips": n_chips,
        "walk_dot_flops": flops,
        "walk_bytes": byts,
        "walk_collective_bytes": coll["total_bytes"],
    }
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    terms["bound_s"] = terms[terms["dominant"]]
    if cfg is not None and case is not None:
        mf = model_flops(cfg, case)
        terms["model_flops_global"] = mf
        # the useful share of the FLOPs one rank runs
        terms["useful_flops_ratio"] = mf / n_chips / flops if flops else None
    return terms
