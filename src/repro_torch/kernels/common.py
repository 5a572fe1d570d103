"""Shared schedule, quantization and decoding plumbing of the digit-serial
kernels (port of `repro/kernels/common.py`).

Every function here is plain PyTorch and is used twice: by the plain
versions the CPU runs, and as the specification the CUDA kernels
(`csrc/*.cu`) reproduce bit for bit.

Subnormal inputs are flushed to zero before any scale is taken. The
reference runs on XLA:CPU and on the TPU, and both treat a float32
subnormal as zero: an all-subnormal slice gets scale 1.0 and all-zero
digits there. PyTorch on the CPU and CUDA without fast-math keep
subnormals, so without the explicit flush such a slice would get scale
2^-125 and nonzero digits, and the port would stop being bit-identical
to its reference on those inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.online_mul import working_precision
from repro_torch.core.precision import OnlinePrecision

__all__ = [
    "schedule_arrays",
    "checked_schedule",
    "fits_int32",
    "resolve_use_pallas",
    "pad_to_multiple",
    "flush_subnormals",
    "pow2_scale",
    "sd_quantize_inkernel",
    "sd_quantize",
    "decode_digits",
    "decode_stream",
    "decode_stream_wide",
    "decode_policy",
    "DECODE_WINDOW_F32",
    "DECODE_WINDOW_WIDE",
    "F32_MIN_NORMAL",
]

# Exact stream-decode windows, in digits. Up to DECODE_WINDOW_F32 every
# term d_i 2^-(i+1) and every partial sum fits the float32 significand,
# so a plain f32 contraction decodes exactly in any order. Up to
# DECODE_WINDOW_WIDE the stream still decodes exactly through an int64
# accumulator rounded to float32 once (round-to-nearest-even); past it
# every consumer refuses (decode_policy raises).
DECODE_WINDOW_F32 = 24
DECODE_WINDOW_WIDE = 48

F32_MIN_NORMAL = 2.0 ** -126


def schedule_arrays(cfg: OnlinePrecision) -> np.ndarray:
    """Static T(j) schedule for j = -delta .. n-1, as an (n+delta,) array."""
    return np.array(
        [working_precision(cfg, j) for j in range(-cfg.delta, cfg.n)],
        dtype=np.int32)


def checked_schedule(cfg: OnlinePrecision) -> tuple[np.ndarray, int]:
    """(T(j) schedule, datapath scale exponent S = max T(j)) for the int32
    kernel datapath, or ValueError when max T(j) + 3 > 31 bits (the
    deepest live slice plus the +-2 residual/selection headroom)."""
    sched = schedule_arrays(cfg)
    S = int(sched.max())
    if S + 3 > 31:
        raise ValueError(
            f"int32 datapath needs max T(j)+3 <= 31, got {S + 3}; "
            "use the int64 plain recurrence for this configuration")
    return sched, S


def fits_int32(cfg: OnlinePrecision) -> bool:
    """Predicate form of `checked_schedule`."""
    try:
        checked_schedule(cfg)
    except ValueError:
        return False
    return True


def resolve_use_pallas(cfg: OnlinePrecision, use_pallas: bool | None) -> bool:
    """The dispatch predicate shared by the digit-serial kernel families,
    decided from the configuration before any launch: a CUDA tensor runs
    the kernel iff the caller allows it (None = auto) and the configuration
    fits the int32 datapath; otherwise the int64 plain version. (The
    reference's name: there the kernel is a Pallas one.)"""
    fits = fits_int32(cfg)
    if use_pallas is None:
        return fits
    return use_pallas and fits


def pad_to_multiple(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad `x` along `axis` up to the next multiple of `mult`."""
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def flush_subnormals(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` with every subnormal replaced by +0 (see module doc)."""
    return torch.where(a.abs() < F32_MIN_NORMAL, torch.zeros_like(a), a)


def pow2_scale(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Power-of-two scale per slice along `axis` (kept as size 1):
    2^(ceil(log2 max|a|) + 1) >= 2 max|a|, so a / scale lies in
    [-1/2, 1/2]. The exponent is read off the float32 bit pattern and the
    scale built by writing the exponent field back, with |max| clamped to
    [2^-126, 2^126]; a max above 2^126 gets an inf scale. All-zero slices
    get scale 1.0, and so do all-subnormal ones (flushed first)."""
    amax = flush_subnormals(a.float()).abs().amax(dim=axis, keepdim=True)
    bits = amax.clamp(F32_MIN_NORMAL, 2.0 ** 126).view(torch.int32)
    e_floor = (bits >> 23) - 127
    e_ceil = torch.where((bits & 0x7FFFFF) == 0, e_floor, e_floor + 1)
    scale = ((e_ceil + 1 + 127) << 23).view(torch.float32)
    scale = torch.where(amax > 2.0 ** 126, torch.full_like(scale, float("inf")),
                        scale)
    return torch.where(amax > 0, scale, torch.ones_like(scale))


def sd_quantize_inkernel(a: torch.Tensor, *, n: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize float slices along the last axis to MSDF signed-digit
    grids: digits (*a.shape, n) int32 in {-1, 0, 1} with
    a ~= scale * sum_i digits_i 2^-(i+1) ... 2^-n, scale a.shape[:-1] + (1,).

    Round half to even at 2^-n (torch.round, like jnp.round). For n <= 31
    the magnitude |v| <= 2^(n-1) is bit-sliced as int32; at n = 32 the
    endpoint |v| = 2^31 does not fit int32, so the exact float magnitude
    is split into two 16-bit halves, as the reference does."""
    if n > 32:
        raise ValueError(
            f"sd digit extraction supports n <= 32, got n={n} (float32 "
            "inputs carry 24 mantissa bits; wider grids encode noise)")
    a = flush_subnormals(a.float())
    scale = pow2_scale(a, -1)
    r = torch.round((a / scale) * (2.0 ** n))
    pos = torch.arange(n, device=a.device, dtype=torch.int32)
    if n <= 31:
        v = r.to(torch.int32)
        sign = torch.sign(v)
        bits = (v.abs()[..., None] >> ((n - 1) - pos)) & 1
        return sign[..., None] * bits, scale
    sign = torch.sign(r).to(torch.int32)
    mag = r.abs()
    hi_f = torch.floor(mag * (2.0 ** -16))
    hi = hi_f.to(torch.int32)
    lo = (mag - hi_f * (2.0 ** 16)).to(torch.int32)
    shift = (n - 1) - pos                                   # 31 .. 0
    bits = torch.where(shift >= 16,
                       (hi[..., None] >> (shift - 16).clamp(min=0)) & 1,
                       (lo[..., None] >> shift.clamp(max=15)) & 1)
    return sign[..., None] * bits, scale


def sd_quantize(a: torch.Tensor, *, n: int, axis: int = -1
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sd_quantize_inkernel` along any axis: digits (*a.shape, n) with
    the digit axis appended, scale with `axis` reduced to 1."""
    ax = axis % a.ndim
    if ax == a.ndim - 1:
        return sd_quantize_inkernel(a, n=n)
    digits, scale = sd_quantize_inkernel(a.movedim(ax, -1), n=n)
    return digits.movedim(-2, ax), scale.movedim(-1, ax)


def decode_digits(z: torch.Tensor, n: int) -> torch.Tensor:
    """SD digit matrix (..., n) -> int64 integer scaled by 2^n, exact for
    n <= 62 (the software form of the hardware's on-the-fly converter)."""
    w = torch.from_numpy(np.int64(1) << np.arange(n - 1, -1, -1,
                                                   dtype=np.int64))
    return (z.to(torch.int64) * w.to(z.device)).sum(-1)


def decode_policy(m: int) -> str:
    """Exact decode a stream of `m` digits needs: "f32" (m <= 24) or
    "wide" (m <= 48); raises past the wide window."""
    if m <= DECODE_WINDOW_F32:
        return "f32"
    if m <= DECODE_WINDOW_WIDE:
        return "wide"
    raise ValueError(
        f"stream length {m} exceeds the {DECODE_WINDOW_WIDE}-digit wide "
        f"(two-limb/int64) exact decode window; lower k_tile or n_bits")


def _stream_weights(m: int, device) -> torch.Tensor:
    """(m,) float32 weights 2^-(i+1), each an exact power of two."""
    w = np.exp2(-np.arange(1, m + 1, dtype=np.float64)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def decode_stream(digits: torch.Tensor) -> torch.Tensor:
    """SD digit stream (..., m) -> float32 sum_i d_i 2^-(i+1). Exact for
    m <= 24 (every partial sum fits the float32 significand, so the
    result does not depend on the reduction order)."""
    if digits.shape[-1] > DECODE_WINDOW_F32:
        raise ValueError(f"stream length {digits.shape[-1]} exceeds the "
                         f"{DECODE_WINDOW_F32}-digit float32 window")
    w = _stream_weights(digits.shape[-1], digits.device)
    return (digits.to(torch.float32) * w).sum(-1)


def decode_stream_wide(digits: torch.Tensor) -> torch.Tensor:
    """Exact float32 stream decode for streams of up to 48 digits: the
    2^m-scaled integer value accumulated exactly in int64 (|sum| < 2^48),
    converted to float32 once (round-to-nearest-even) and rescaled by the
    exact power 2^-m. This is the reference's int64 branch; its two-limb
    float32 branch rounds the same exact value once by the same rule, so
    both give the same bits."""
    m = digits.shape[-1]
    if m > DECODE_WINDOW_WIDE:
        raise ValueError(f"stream length {m} exceeds the wide decode "
                         f"window of {DECODE_WINDOW_WIDE} digits")
    w = torch.from_numpy(np.int64(1) << np.arange(m - 1, -1, -1,
                                                   dtype=np.int64))
    total = (digits.to(torch.int64) * w.to(digits.device)).sum(-1)
    return total.to(torch.float32) * (2.0 ** -m)
