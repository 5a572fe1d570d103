"""Mixture-of-Experts layer: top-k routing, capacity-based sort dispatch
(port of `repro/models/moe.py`).

Dispatch is gather-based: each batch row's token assignments are sorted
by expert id (stably), each assignment's position within its expert comes
from the sorted order, and tokens are gathered into a (B, E, C, d)
buffer. Assignments past an expert's capacity C go to a sink slot and
are dropped: their combine weight is zero, so the residual passes
through. The router and the expert GEMMs are plain matmuls, as they are
plain `jnp.einsum` in the reference: under a digit mode an MoE layer runs
the DotEngine on its attention GEMMs only. The combine adds each token's
kept updates one by one in ascending slot order (`_combine`), so its bits
do not depend on the device: no atomic sum.

Under a partition context (`distributed/partition.py`) every rank routes
the same tokens alike, runs the expert GEMMs on its block of the expert
leaves and combines its updates into an f32 partial that one all-reduce
over `model` sums: what GSPMD makes of the reference's `constrain` calls.
Under gradients the layer's input and its combine weights enter the
rank's experts, their gradients summed over `model` (`_partitioned`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import Keep, _whole

Params = Dict[str, Any]

__all__ = ["moe_init", "moe_apply"]


def _stacked_init(gen: torch.Generator, E: int, d_in: int, d_out: int,
                  dtype, device) -> torch.Tensor:
    """E experts' (d_in, d_out) weights at dense_init's scale, drawn in
    one call (no per-expert copies of a layer's largest tensors)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig, device,
             keep: Keep = _whole) -> Params:
    """`keep(name, leaf)` takes each leaf as it is drawn, before the next
    draw (Model.init): a rank holds one whole expert stack at a time."""
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.pdtype
    p = {"router": keep("router", _stacked_init(gen, 1, d, E, torch.float32,
                                                device)[0])}
    for key, (d_in, d_out) in (("wg", (d, f)), ("wu", (d, f)),  # (E, d, f)
                               ("wd", (f, d))):
        p[key] = keep(key, _stacked_init(gen, E, d_in, d_out, dt, device))
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 for tiling


def _route_rows(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Route each batch row's T tokens on its own, every row in one call:
    x (B, T, d). Returns each row's dispatch plan (token id per (expert,
    slot) (B, E*C), each sorted assignment's slot (sink E*C when dropped),
    token, weight and keep flag (B, T*K)) and each row's aux loss E *
    sum(me * ce) (B,), as the reference's `_route_row` vmapped over the
    rows gives them."""
    B, T = x.shape[:2]
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(T, cfg)
    dev = x.device
    # the router in f32 whatever its dtype, as the reference's einsum
    # promotes it (bf16 when a train step casts the stacked layers' leaves)
    gates = torch.softmax(torch.matmul(x.to(torch.float32),
                                       router.to(torch.float32)), dim=-1)
    # jax.lax.top_k's order: descending, the lower index first among ties
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :K], idx[..., :K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    me = gates.mean(dim=1)                                       # (B, E)
    ce = torch.zeros((B, E), dtype=torch.float32, device=dev).scatter_add_(
        1, topi.reshape(B, -1), torch.ones((B, T * K), device=dev)) / (T * K)
    aux = E * torch.sum(me * ce, dim=-1)

    flat_e = topi.reshape(B, -1)                                 # (B, T*K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K).expand(B, -1)
    flat_w = topw.reshape(B, -1)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se, st, sw = (t.gather(1, order) for t in (flat_e, flat_t, flat_w))
    pos = (torch.arange(T * K, device=dev)
           - torch.searchsorted(se, se, side="left"))
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    # a scatter over every assignment, no boolean index: the shapes depend
    # on T alone (a meta walk has no values to count). A dropped
    # assignment writes the empty mark T to the sink slot E * C, which the
    # plan cuts off.
    buf_tok = torch.full((B, E * C + 1), T, dtype=torch.int64, device=dev)
    buf_tok.scatter_(1, slot, torch.where(keep, st, torch.full_like(st, T)))
    return buf_tok[:, :-1], slot, st, sw, keep, aux


def _route_row(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """One batch row's plan, xt (T, d): `_route_rows` of the one row (the
    reference's `_route_row`)."""
    return tuple(t[0] for t in _route_rows(xt[None], router, cfg))


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              eng: DotEngine, part=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), aux loss ()). Routing is per
    batch row, every row in one call (`_route_rows`); the experts run one
    batched matmul over (B, E, C, d).
    `eng` is the block's MLP engine, which the reference's expert einsums
    do not use either. A partition context `part` runs the layer on this
    rank's expert blocks (`_partitioned`)."""
    B, S, d = x.shape
    E = cfg.n_experts
    C = _capacity(S, cfg)                              # per-row capacity
    buf_tok, slot, st, sw, keep, aux = _route_rows(x, p["router"], cfg)
    aux = aux.mean()
    if part is not None:
        return _partitioned(p, x, buf_tok.reshape(B, E, C), slot, st,
                            torch.where(keep, sw, torch.zeros_like(sw)),
                            part), aux

    buf_ec = buf_tok.reshape(B, E, C)                  # token id per slot
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=x.device)[:, None, None]
    xe = x_pad[rows, buf_ec]                           # (B, E, C, d)

    wg, wu, wd = (p[k].to(x.dtype) for k in ("wg", "wu", "wd"))
    g = F.silu(torch.einsum("becd,edf->becf", xe, wg).to(torch.float32))
    u = torch.einsum("becd,edf->becf", xe, wu)
    ye = torch.einsum("becf,efd->becd", g.to(x.dtype) * u, wd)

    # per-slot combine weights aligned to the (E, C) buffer
    wslot = torch.zeros((B, E * C + 1), dtype=torch.float32, device=x.device)
    wslot.scatter_(1, slot, torch.where(keep, sw, torch.zeros_like(sw)))
    upd = ye * wslot[:, :-1].reshape(B, E, C)[..., None].to(x.dtype)
    return _combine(upd.reshape(B, E * C, d), slot, st, S, 0), aux


def _combine(upd: torch.Tensor, slot: torch.Tensor, st: torch.Tensor,
             T: int, lo: int) -> torch.Tensor:
    """Each of T tokens' updates summed in a fixed order: upd (B, n, d)
    holds the updates of slots lo .. lo + n - 1, slot and st (B, T * K)
    each assignment's slot (sink E * C when dropped) and token. Returns
    (B, T, d) in upd's dtype: zeros, plus the token's K updates one add at
    a time in ascending slot order, each sum rounded to that dtype. A
    dropped assignment, or a slot outside the n, adds an exact zero. This
    is the order of the reference's scatter-add and of the CPU's
    index_add_; CUDA's index_add_ adds with atomics, in no fixed order,
    and a reduction that rounds once rounds otherwise."""
    B, n, d = upd.shape
    K = slot.shape[1] // T
    # a token's assignments, grouped by a stable sort on the token, then
    # its K slots ascending
    by_tok = slot.gather(1, torch.argsort(st, dim=1, stable=True))
    mine = torch.sort(by_tok.reshape(B, T, K), dim=-1).values - lo
    held = (mine >= 0) & (mine < n)
    mine = mine.clamp(0, n - 1)
    rows = torch.arange(B, device=upd.device)[:, None]
    out = torch.zeros((B, T, d), dtype=upd.dtype, device=upd.device)
    for k in range(K):
        out = out + torch.where(held[..., k, None], upd[rows, mine[..., k]],
                                0.0)
    return out


def _partitioned(p: Params, x: torch.Tensor, buf_ec: torch.Tensor,
                 slot: torch.Tensor, st: torch.Tensor, w: torch.Tensor,
                 part) -> torch.Tensor:
    """The experts and the combine on this rank's blocks, from the plan
    every rank made alike: the token id of each (expert, slot) buf_ec
    (B, E, C), each assignment's slot (sink E * C when dropped), token and
    combine weight w (zero when dropped), (B, T * K).

    Under ep the rank gathers the tokens of its experts alone and its
    einsums give their whole updates; under tp it gathers every expert's
    tokens, g and u on its d_ff columns, and wd on its rows an f32 partial
    of every update. Each expert leaf is whole over `data` only inside its
    einsum. The rank combines its weighted updates (`_combine`) into an
    f32 (B, S, d), summed once over `model` and cast once to x's dtype.

    Under gradients x and the combine weights w, the same on every rank,
    enter the rank's experts (`Partition.enter`): each rank's gradient of
    them is a partial (its experts' tokens, its d_ff block's share), which
    the backward sums over `model`; the router's gradient and x's through
    the routing are then whole on every rank."""
    x, w = part.enter(x), part.enter(w)
    B, S, d = x.shape
    E, C = buf_ec.shape[1:]
    e0, e1 = part.expert_range()
    mine = buf_ec[:, e0:e1]                            # (B, El, C)
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=x.device)[:, None, None]
    xe = x_pad[rows, mine]                             # (B, El, C, d)
    g = F.silu(torch.einsum("becd,edf->becf", xe, part.expert(p, "wg").to(
        x.dtype)).to(torch.float32)).to(x.dtype)
    u = torch.einsum("becd,edf->becf", xe, part.expert(p, "wu").to(x.dtype))
    del xe
    if part.experts_by == "ep":
        ye = torch.einsum("becf,efd->becd", g * u,
                          part.expert(p, "wd").to(x.dtype)).to(torch.float32)
    else:
        ye = torch.einsum("becf,efd->becd", (g * u).to(torch.float32),
                          part.expert(p, "wd").to(torch.float32))
    del g, u
    wslot = torch.zeros((B, E * C + 1), dtype=torch.float32, device=x.device)
    wslot.scatter_(1, slot, w.to(torch.float32))
    upd = ye * wslot[:, :-1].reshape(B, E, C)[:, e0:e1, :, None]
    out = _combine(upd.reshape(B, -1, d), slot, st, S, e0 * C)
    return part.sum(out).to(x.dtype)
