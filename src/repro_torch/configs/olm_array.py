"""The paper's own configuration: online-multiplier inner-product arrays at
n = 8/16/24/32 digits (delta=3, t=2, Eq. 8 truncation, G=2 tail), and the
DotEngine wiring that selects them as a model's matmul numerics."""
from repro_torch.core.numerics import (TRUNCATED_SPECS, DotEngine,
                                       EngineSpec, resolve_engine)

# Every array width is a registered DotEngine matmul mode.
MATMUL_MODES = {8: "olm8", 16: "olm16", 24: "olm24", 32: "olm32"}

# Truncated working-precision tiers, keyed (n, p): mode olm{n}t{p} runs
# truncation_schedule(n, p), the p-digit array.
TRUNCATED_MODES = {(n, p): f"olm{n}t{p}" for n, p in TRUNCATED_SPECS}


# The reference's static tiling: k_tile lanes per adder tree (a numerics
# parameter) and the (block_m, block_n) output tile, which on Hopper pins
# K1/K2's block rows and columns (matmul_kernel.launch_plan). It is what
# `engine_for(..., tiling=None)` pins and a candidate the autotuner always
# races.
MATMUL_TILING = {"k_tile": 16, "block_m": 8, "block_n": 8}


def engine_for(n_bits: int, *, trunc: int | None = None,
               tiling: str | None = "auto", **overrides) -> DotEngine:
    """DotEngine running every model GEMM through the n_bits-digit array;
    trunc=p selects the truncated tier olm{n}t{p}. tiling="auto" (the
    default) has the autotuner (kernels/online_dot/tuning) choose each
    GEMM's launch plan, with k_tile at the kernel's numerics default;
    tiling=None pins MATMUL_TILING. Any DotEngine field may be overridden
    and wins over the autotuner. The engine is resolved through
    EngineSpec, as the reference's is."""
    if trunc is not None:
        if (n_bits, trunc) not in TRUNCATED_MODES:
            raise ValueError(
                f"no truncated olm mode at n_bits={n_bits} trunc={trunc}; "
                f"available: {sorted(TRUNCATED_MODES)}")
        mode = TRUNCATED_MODES[(n_bits, trunc)]
    elif n_bits in MATMUL_MODES:
        mode = MATMUL_MODES[n_bits]
    else:
        raise ValueError(
            f"no olm matmul mode at n_bits={n_bits}; "
            f"available: {sorted(MATMUL_MODES)}")
    if tiling not in (None, "auto"):
        raise ValueError(f"tiling must be 'auto' or None, got {tiling!r}")
    base = {"tiling": "auto"} if tiling == "auto" else dict(MATMUL_TILING)
    return resolve_engine(EngineSpec(mode=mode, **{**base, **overrides}))
