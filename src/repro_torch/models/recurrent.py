"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and Mamba2 SSD (port
of `repro/models/recurrent.py`).

Both are attention-free sequence mixers with an O(1) decode state.

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            input gate
    a_t = a^(c * r_t)      (a = sigmoid(Lambda), c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
computed with an associative scan over (a, b) pairs in prefill and a
single step in decode.

Mamba2 SSD (arXiv:2405.21060), the chunked algorithm: an intra-chunk
quadratic term and an inter-chunk recurrence over chunk-final states.

The projections wx, wy, wo (RG-LRU) and win, wout (SSD) go through the
DotEngine, so they run K1 under olm16; the RG-LRU gates wa and wi and
every SSD contraction are plain matmuls, as they are plain `jnp.einsum`
in the reference. A state dict passed in is updated in place (its `h`
and `conv` keep their f32 storage), as the attention caches are.

Under a partition context (`distributed/partition.py`) the RG-LRU runs on
this rank's channels, as GSPMD runs the reference's specs: wx and wy
column-parallel, the depthwise conv, the gates' output columns, the scan
and the f32 state on the rank's block of the w channels, the whole u
gathered over `model` once a layer for the wa and wi products, and wo
row-parallel. The SSD block has no partitioned form: the Sharder
replicates its weights and splits only the batch, so it runs whole on
the rank's rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import Keep, _col, _row, _whole, dense_init

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]

__all__ = ["RGLRU_C", "associative_scan", "rglru_init", "rglru_apply",
           "rglru_state_init", "ssd_init", "ssd_chunked", "ssd_apply",
           "ssd_state_init"]

RGLRU_C = 8.0


# --------------------------------------------------------------------------
# the associative scan, paired as jax.lax.associative_scan pairs it
# --------------------------------------------------------------------------

def _along(t: torch.Tensor, dim: int, start=None, stop=None, step=None
           ) -> torch.Tensor:
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even, b at the odd positions along `dim` (len(a) is
    len(b) or len(b) + 1)."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int
                     ) -> list:
    """Inclusive scan of the tuple `elems` along `dim` under the
    associative `fn(left, right)`, with the odd/even recursion of
    jax.lax.associative_scan: pairs (0,1), (2,3), ... are combined, the
    half-length result is scanned recursively (the odd outputs), and each
    even output is the preceding odd output combined with its own element.
    The same pairing gives the same f32 products as the reference."""
    elems = list(elems)
    dim = dim % elems[0].ndim
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn([_along(e, dim, 0, -1, 2) for e in elems],
                 [_along(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([_along(e, dim, 0, -1) for e in odd],
                  [_along(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_along(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_along(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _linear_combine(left, right):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    (a1, b1), (a2, b2) = left, right
    return [a1 * a2, a2 * b1 + b2]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _write_state(state: Optional[State], new: State) -> None:
    """Copy the new state into the caller's tensors (none to keep: None)."""
    if state is not None:
        for key, t in new.items():
            state[key].copy_(t)


# --------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block: conv1d + gated linear recurrence)
# --------------------------------------------------------------------------

def rglru_init(gen: torch.Generator, cfg: ModelConfig, device,
               keep: Keep = _whole) -> Params:
    """`keep(name, leaf)` takes each leaf as it is drawn, before the next
    draw, and returns what the tree holds (Model.init)."""
    d, dt = cfg.d_model, cfg.pdtype
    w = cfg.rnn_width or d
    # Lambda init so a = sigmoid(L)^c is in ~(0.9, 0.999); kept f32
    lam = keep("lam", 2.0 + 4.0 * torch.rand(
        (w,), generator=gen, dtype=torch.float32, device=device))
    conv = keep("conv", (torch.randn((cfg.conv_width, w), generator=gen,
                                     dtype=torch.float32, device=device)
                         * 0.1).to(dt))

    def dense(name, d_in, d_out):
        return keep(name, dense_init(gen, d_in, d_out, dt, device))

    def zeros(name):
        return keep(name, torch.zeros((w,), dtype=dt, device=device))

    wx = dense("wx", d, w)                             # recurrence branch
    wy = dense("wy", d, w)                             # gate branch
    wa, ba = dense("wa", w, w), zeros("ba")
    wi, bi = dense("wi", w, w), zeros("bi")
    return {"wx": wx, "wy": wy, "conv": conv, "wa": wa, "ba": ba,
            "wi": wi, "bi": bi, "lam": lam, "wo": dense("wo", w, d)}


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, w), kernel (K, w). Returns (y, the
    last K-1 inputs (B, K-1, w)), which a decode step carries as its
    state."""
    K = kernel.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * kernel[i].to(x.dtype)[None, None]
            for i in range(K))
    return y, xp[:, -(K - 1):, :]


def _rglru_coeffs(p: Params, u: torch.Tensor, part=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan's (a_t, b_t), f32. The gate GEMMs are plain matmuls.
    Under a partition context u holds this rank's channels and the
    gates' products take the whole u, gathered over `model` once for
    both, on the rank's output columns of wa and wi (under gradients the
    gather's backward sums u's gradient over `model` and keeps the
    rank's channels)."""
    f32 = torch.float32
    whole = u if part is None else part.gather(u, -1)
    r = torch.sigmoid(torch.matmul(whole, p["wa"].to(u.dtype)).to(f32)
                      + p["ba"].to(f32))
    i = torch.sigmoid(torch.matmul(whole, p["wi"].to(u.dtype)).to(f32)
                      + p["bi"].to(f32))
    del whole
    # lam in its own dtype, as the reference's log_sigmoid takes it (bf16
    # when a train step casts the stacked layers' leaves)
    log_a = RGLRU_C * r * F.logsigmoid(p["lam"])[None, None]
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.to(f32))
    return a, b


def rglru_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                eng: DotEngine, state: Optional[State] = None, part=None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d). state = {"h": (B, w), "conv": (B, K-1, w)}: with S == 1
    one decode step, else a prefill from that state. Under a partition
    context `part` the params and the state are this rank's blocks (w
    over `model`) and every step but the gates' products and wo's sum
    stays on the rank's channels."""
    if part is not None:
        x = part.enter(x)
    u = _col(eng, x, p["wx"], part)                    # (B, S, w)
    gate = F.gelu(_col(eng, x, p["wy"], part).to(torch.float32),
                  approximate="tanh")
    u, new_conv = _causal_conv(u, p["conv"],
                               None if state is None else state["conv"])
    a, b = _rglru_coeffs(p, u, part)
    if state is not None and x.shape[1] == 1:
        h = a[:, 0] * state["h"] + b[:, 0]             # one decode step
        _write_state(state, {"h": h, "conv": new_conv})
        h = h[:, None]
    else:
        # h_t = a_t h_{t-1} + b_t from h_0, as an associative scan
        a_run, h = associative_scan(_linear_combine, (a, b), dim=1)
        if state is not None:                          # prefill from state
            h = h + a_run * state["h"][:, None]
        _write_state(state, {"h": h[:, -1], "conv": new_conv})
    y = h.to(x.dtype) * gate.to(x.dtype)
    return _row(eng, y, p["wo"], part), state


def rglru_state_init(cfg: ModelConfig, batch: int, device) -> State:
    w = cfg.rnn_width or cfg.d_model
    f32 = torch.float32
    return {"h": torch.zeros((batch, w), dtype=f32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=f32,
                                device=device)}


# --------------------------------------------------------------------------
# Mamba2 / SSD block
# --------------------------------------------------------------------------

def ssd_init(gen: torch.Generator, cfg: ModelConfig, device,
             keep: Keep = _whole) -> Params:
    """`keep(name, leaf)` takes each leaf as it is drawn, before the next
    draw, and returns what the tree holds (Model.init)."""
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    dt, f32 = cfg.pdtype, torch.float32
    win = keep("win", dense_init(gen, d, 2 * din + 2 * N + H, dt, device))
    conv = keep("conv", (torch.randn((cfg.conv_width, din + 2 * N),
                                     generator=gen, dtype=f32, device=device)
                         * 0.1).to(dt))
    rates = 1.0 + 15.0 * torch.rand((H,), generator=gen, dtype=f32,
                                    device=device)
    return {
        "win": win,
        "conv": conv,
        "a_log": keep("a_log", torch.log(rates)),      # f32 whatever dt is
        "dt_bias": keep("dt_bias", torch.zeros((H,), dtype=f32,
                                               device=device)),
        "d_skip": keep("d_skip", torch.ones((H,), dtype=f32, device=device)),
        "norm": keep("norm", torch.ones((din,), dtype=dt, device=device)),
        "wout": keep("wout", dense_init(gen, din, d, dt, device)),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L) lower-triangular segment sums; -inf above
    the diagonal, so exp() makes those entries exactly 0."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """SSD forward: xh (B, S, H, P), dt (B, S, H) >= 0, A (H,) < 0 decay
    rates, Bm/Cm (B, S, N), S a multiple of `chunk`, optional initial
    state h0 (B, H, P, N). Returns (y (B, S, H, P), final state
    (B, H, P, N))."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    dA = (dtc * A[None, None, None]).movedim(-1, 2)   # (B, nc, H, L) <= 0

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA))                     # (B, nc, H, L, L)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcls,bcsh,bcshp->bclhp",
                          Lmat, scores, dtc, xc)

    # chunk-final states
    rev = torch.flip(torch.cumsum(torch.flip(dA, [-1]), dim=-1), [-1])
    decay_to_end = torch.exp(rev - dA)                # prod over steps > l
    states = torch.einsum("bchl,bclh,bcln,bclhp->bchpn",
                          decay_to_end, dtc, Bc, xc)  # (B, nc, H, P, N)

    # inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(dA.sum(dim=-1))           # (B, nc, H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c].float()
    h_prev = torch.stack(entering, dim=1)             # state entering chunk

    # the previous state's contribution to each position
    decay_in = torch.exp(torch.cumsum(dA, dim=-1))    # (B, nc, H, L)
    y_off = torch.einsum("bcln,bchl,bchpn->bclhp",
                         Cc, decay_in, h_prev.to(Cc.dtype))
    return (y_diag + y_off).reshape(Bsz, S, H, P), h


def ssd_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, eng: DotEngine,
              state: Optional[State] = None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (B, S, d). state = {"h": (B, H, P, N), "conv": (B, K-1, din+2N)}:
    with S == 1 one decode step, else a prefill from that state."""
    B, S, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    f32 = torch.float32
    z, xin, Bm, Cm, dt = torch.split(eng.dot(x, p["win"]),
                                     [din, din, N, N, H], dim=-1)
    conv_out, new_conv = _causal_conv(
        torch.cat([xin, Bm, Cm], dim=-1), p["conv"],
        None if state is None else state["conv"])
    conv_out = F.silu(conv_out.to(f32)).to(x.dtype)
    xin, Bm, Cm = torch.split(conv_out, [din, N, N], dim=-1)
    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32)[None, None])
    A = -torch.exp(p["a_log"])            # (H,) negative rates, a_log's dtype
    xh = xin.reshape(B, S, H, P)

    if state is not None and S == 1:
        # one recurrent step
        dA = torch.exp(dt[:, 0] * A[None])             # (B, H)
        h = state["h"] * dA[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].to(f32),
            xh[:, 0].to(f32))
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), h)[:, None]
    else:
        # pad to a chunk multiple; padded steps get dt = 0 (identity
        # decay, zero input), so the carried-out state is exact
        pad = (-S) % cfg.ssm_chunk
        xh_p = F.pad(xh.to(f32), (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(Bm.to(f32), (0, 0, 0, pad))
        Cp = F.pad(Cm.to(f32), (0, 0, 0, pad))
        y, h = ssd_chunked(xh_p, dt_p, A, Bp, Cp, cfg.ssm_chunk,
                           h0=None if state is None else state["h"])
        y = y[:, :S]
    _write_state(state, {"h": h, "conv": new_conv})
    y = y + xh.to(f32) * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(B, S, din) * F.silu(z.to(f32))
    # grouped RMS norm
    var = (y * y).mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm"].to(f32)
    return eng.dot(y.to(x.dtype), p["wout"]), state


def ssd_state_init(cfg: ModelConfig, batch: int, device) -> State:
    f32 = torch.float32
    return {
        "h": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=f32,
                            device=device),
    }
