"""The partition context of the partitioned serve steps: what GSPMD does
with the reference's `jit_prefill_step` / `jit_decode_step` shardings,
done by hand for the dense, MoE, recurrent and cross-attention families
(the SSM family's weights are replicated: its step runs with no context).

A `Partition` is the Sharder (its mesh, its config, its specs) plus this
rank's coordinate along `model`. The layers (`models/layers.py`) take one
as `part=`; with None they run on whole tensors. Under one, each rank
holds its blocks at the Sharder's specs and:

  * column-parallel GEMMs (wq, wk, wv, wg, wu, the head) run on the
    rank's columns and their outputs stay sharded: the n-partition of
    `kernels/online_dot/matmul_sharded.py`, under a digit mode
    bit-identical to one device's GEMM on those columns;
  * row-parallel GEMMs (wo, wd) run on the rank's K block with an f32
    result; the partials are all-reduced over `model` in f32 and cast
    once to the compute dtype: the k-partition, within olm_error_bound
    under a digit mode (the order of the sum differs);
  * under fsdp_tp a weight's `data`-sharded dim is all-gathered just
    before its GEMM and dropped after it (ZeRO-3 a layer: at most one
    weight is whole over `data` at a time);
  * the embedding is vocab-parallel (under fsdp_tp its looked-up rows
    gathered over `data` where they are fewer than the table's), the KV
    cache split over kv heads or over its length (a sliding-window ring
    too), attention over whole heads (`layers.py`); cross-attention and
    the enc-dec encoder's cache-less layers read k and v of the rank's kv
    heads, or gathered whole where the kv heads do not divide `model`,
    the memory being the rank's rows whole over `model`;
  * a MoE layer routes on every rank alike (the router is replicated and
    its input the same bits everywhere), runs its expert GEMMs on the
    rank's experts (`ep`) or on every expert's d_ff block (`tp`), the
    layout the Sharder's spec of the expert leaves gives, and sums the
    combined f32 partials once over `model` (`models/moe.py`);
  * an RG-LRU layer (`models/recurrent.py`) keeps its conv, gates, scan
    and f32 state on the rank's channels: wx and wy column-parallel, the
    whole u gathered over `model` once for the wa and wi products on the
    rank's output columns, wo row-parallel.

The collectives are the c10d calls of `collectives.py` on the mesh's
groups: gloo on the CPU and between ranks that share a card.

The partitioned train step (`distributed/train.py::jit_train_step`) runs
the same layers under gradients; each crossing carries its Megatron pair
(`collectives.py`'s Functions, inert under no_grad, so the serve steps
keep their bits):
  * `enter`: a tensor whole over `model` (the same on every rank) going
    into the rank's columns: identity forward, its gradient summed over
    `model` backward. Each layer calls it once on its input (attention,
    the MLP, the RG-LRU, the head; the MoE layer on its input and its
    combine weights), not once a GEMM;
  * `row` and `sum`: the partials summed forward, the identity backward;
  * `whole_over_data`: the all-gather over `data` forward, the weight's
    gradient reduce-scattered over `data` backward, in f32 (ZeRO-3: it
    lands in the rank's block, summed over the data ranks);
  * `gather`: the all-gather over `model` forward, a reduce-scatter
    backward (every training call site feeds rank-specific work: k and v
    for the rank's heads, the heads' outputs for its columns, the RG-LRU's
    u for its gate columns);
  * `max`: detached (the softmax's shift moves no gradient).
Every tensor whole over `model` that feeds rank-specific work gets its
gradient summed over `model` once, and nothing is summed twice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from repro_torch.launch.mesh import MODEL_AXIS
from .collectives import (all_gather_dim, all_reduce_max,
                          axis_coordinate, enter, gather_over, sum_over)
from .sharding import Sharder

__all__ = ["Partition"]


class Partition:
    def __init__(self, sharder: Sharder):
        self.sharder = sharder
        self.mesh = sharder.mesh
        self.cfg = sharder.cfg
        self.rank, self.size = axis_coordinate(self.mesh, MODEL_AXIS)
        # the axis a weight's non-model dim is split over (fsdp_tp) or None
        self.fs = sharder._fs()
        # the KV cache over kv heads, else over its length (cache_spec)
        self.kv_by_heads = self.cfg.n_kv_heads % self.size == 0
        # each expert leaf's spec, from its whole shape: "ep" splits the
        # experts over `model`, "tp" their d_ff (also where the config asks
        # for ep but the experts do not divide `model`)
        cfg = self.cfg
        if cfg.n_experts:
            E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
            self.expert_specs = {
                leaf: sharder.param_spec(f"moe/{leaf}", shape)
                for leaf, shape in (("wg", (E, d, f)), ("wu", (E, d, f)),
                                    ("wd", (E, f, d)))}
            self.experts_by = ("ep" if self.expert_specs["wg"][0] == "model"
                               else "tp")

    def whole_over_data(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """w with its `data`-sharded dim gathered (fsdp_tp), as it goes
        into one GEMM; w itself under tp. Its gradient is reduce-scattered
        back over `data`."""
        return w if self.fs is None else gather_over(w, dim, self.mesh,
                                                     self.fs)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
        """table[ids], its rows whole over `data`, where table is this
        rank's block of a table whose d is split over `data` (fsdp_tp;
        under tp, table[ids]). Where the ids of every rank along `data`
        are fewer than the table's rows (a decode, a short batch), each
        rank looks up its columns of all of them and the rows are gathered
        over `data`; else the table is, as for a GEMM. Either way the
        gradient is reduce-scattered back over `data`."""
        if self.fs is None:
            return table[ids]
        c, n = axis_coordinate(self.mesh, self.fs)
        if n * ids.numel() >= table.shape[0]:
            return self.whole_over_data(table, 1)[ids]
        every = all_gather_dim(ids, 0, self.mesh, self.fs)
        return self.whole_over_data(table[every], -1).narrow(
            0, c * ids.shape[0], ids.shape[0])

    def expert_range(self) -> Tuple[int, int]:
        """[e0, e1) of the experts whose GEMMs this rank runs: its block
        of them under ep, all of them under tp."""
        E = self.cfg.n_experts
        if self.experts_by == "tp":
            return 0, E
        return E * self.rank // self.size, E * (self.rank + 1) // self.size

    def expert_data_dim(self, leaf: str) -> Optional[int]:
        """The dim of expert leaf `leaf` ("wg", "wu", "wd") split over
        `data` (fsdp_tp), None where none is: dim 1 of all three under ep
        (d of wg and wu, f of wd), dim 1 of wg / wu and dim 2 of wd under
        tp."""
        spec = self.expert_specs[leaf]
        if self.fs is None or self.fs not in spec:
            return None
        return spec.index(self.fs)

    def expert(self, p, leaf: str) -> torch.Tensor:
        """This rank's block of expert leaf `leaf` of a MoE layer's params
        `p`, whole over `data`, as it goes into one einsum."""
        dim = self.expert_data_dim(leaf)
        return p[leaf] if dim is None else self.whole_over_data(p[leaf], dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x, whole over `model`, as it goes into this rank's blocks: its
        gradient summed over `model`."""
        return enter(x, self.mesh, MODEL_AXIS)

    def col(self, eng: DotEngine, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
        """x (..., K) @ this rank's columns (K, N / size): the output's
        columns, left sharded. x is the layer's input after `enter`."""
        return eng.dot(x, self.whole_over_data(w, 0))

    def row(self, eng: DotEngine, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
        """x (..., K / size) @ this rank's rows (K / size, N): the f32
        partials summed over `model`, cast once to x's dtype."""
        out = eng.dot(x.to(torch.float32), self.whole_over_data(w, 1))
        return self.sum(out).to(x.dtype)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """t's blocks along `model`, concatenated along `dim`; under
        gradients a reduce-scatter backward."""
        return gather_over(t, dim % t.ndim, self.mesh, MODEL_AXIS)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over `model` (in place under no_grad)."""
        return sum_over(t, self.mesh, MODEL_AXIS)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """t's elementwise largest over `model`, detached."""
        return all_reduce_max(t.detach(), self.mesh, MODEL_AXIS)

    def head_range(self, heads: int, rank: Optional[int] = None
                   ) -> Tuple[int, int]:
        """[lo, hi) of the whole heads `rank` (this one by default) attends
        for: heads * r // size up to heads * (r + 1) // size, the near-even
        split where the heads do not divide `model` (56 over 16: 3 or 4)."""
        r = self.rank if rank is None else rank
        return heads * r // self.size, heads * (r + 1) // self.size

    def heads_to_columns(self, out: torch.Tensor, heads: int
                         ) -> torch.Tensor:
        """This rank's columns of the attention output (B, S, heads * Dh)
        from each rank's whole heads out (B, S, hi - lo, Dh): every rank's
        heads gathered over `model` (padded to the largest share), then
        the even column block that wo's rows take."""
        B, S, _, Dh = out.shape
        most = -(-heads // self.size)
        pad = most - out.shape[2]
        if pad:
            out = torch.cat([out, out.new_zeros((B, S, pad, Dh))], dim=2)
        every = self.gather(out, 2)
        keep: list = []
        for r in range(self.size):
            lo, hi = self.head_range(heads, r)
            keep += range(r * most, r * most + hi - lo)
        whole = every[:, :, keep].reshape(B, S, heads * Dh)
        n = heads * Dh // self.size
        return whole[..., self.rank * n:(self.rank + 1) * n]
