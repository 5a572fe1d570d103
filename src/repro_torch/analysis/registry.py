"""Registered-kernel enumeration for the port's kernel engine (port of
`repro/analysis/registry.py`).

One KernelCase per (kernel, width, representative shape bucket). Where the
reference traces each Pallas body's jaxpr, a case here names the Hopper
kernel's launch plan: what the host's planner would launch for the shape
(K1 and K2: `matmul_kernel.launch_plan`, K3: `kernel.launch_plan`, K4:
its fixed blocks, K5: `tile_shape` / `split_plan`), so the smem engine
checks it against Hopper's limits on the CPU and the card's own occupancy
API in `chip_smoke.py`'s lint phase. Building a plan costs no device
memory and no FLOPs.

The buckets keep the reference's labels and shapes: the static
`MATMUL_TILING` default, the decode GEMV, the training GEMM, and their
shard-local mates over an 8-way mesh axis. The tilings differ by design:
the reference's were built for VMEM and the TPU's lane budget, the port's
come from its own planner (`tuning.heuristic_tiling`, which is
`launch_plan` with nothing pinned). The static bucket is the training
GEMM's shape with `MATMUL_TILING`'s blocks pinned, as `engine_for(...,
tiling=None)` launches it. No bucket is dropped as a duplicate of
another: a plan check costs microseconds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.configs.olm_array import (MATMUL_MODES, MATMUL_TILING,
                                           TRUNCATED_SPECS)
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import kernel as k3
from repro_torch.kernels.online_dot import matmul_kernel as k12
from repro_torch.kernels.online_dot.ref import tree_levels
from repro_torch.kernels.online_dot.tuning import (Tiling, heuristic_tiling,
                                                   pinned_k_tile)
from repro_torch.kernels.online_mul import kernel as k4
from repro_torch.kernels.tpmm import kernel as k5
from repro_torch.kernels.tpmm.ref import kept_levels, num_planes_for

__all__ = ["BUCKETS", "OUT_DTYPES", "Launch", "KernelCase", "matmul_launch",
           "representative_tilings", "iter_cases"]

# label -> (M, N, K): the reference's buckets, labels and shapes.
BUCKETS: Dict[str, Tuple[int, int, int]] = {
    "gemv": (1, 4096, 4096),
    "train": (8192, 4096, 4096),
    # shard-local mates over an 8-device axis: the decode GEMV N-sharded,
    # the training GEMM M-sharded and K-sharded
    "shard8-gemv-n": (1, 512, 4096),
    "shard8-train-m": (1024, 4096, 4096),
    "shard8-train-k": (8192, 4096, 512),
}
STATIC_SHAPE = BUCKETS["train"]

# The dtype each kernel writes (the kernel-accum-dtype contract): f32 GEMM
# accumulators, int32 digit streams.
OUT_DTYPES = {"olm_matmul_fused": "float32", "olm_matmul_host": "float32",
              "online_dot": "int32", "online_dot_any": "int32",
              "online_mul": "int32", "tpmm": "float32"}

# K3's representative rows and lanes: a whole stage, the chip smoke's
# timed K, one whole level-10 subtree, and rows of 2 and 8 subtrees
# (InternLM2-1.8B's d_model and d_ff); the general kernel's at one lane a
# row (K4's general route), a stage and two subtrees, in each residual
# datapath; K4's a timed batch.
DOT_B = 4096
DOT_KS = (16, 256, k3.MAX_LANES, 2048, 8192)
ANY_KS = (1, 256, 2048)
MUL_B = 1 << 20


@dataclasses.dataclass(frozen=True)
class Launch:
    """What one launch asks of the card, in the kernel's own terms.
    `geometry` is the argument tuple of the kernel module's `geometry`
    query (K1/K2: (n, host, vec, bm, bn, tb, L); K3 and its general
    kernel: (n, vec, rows, L, general, wide); K5: (D, M, levels)), None
    for K4, whose static shared memory the
    lint phase reads from ptxas instead (`smem.check_static_smem`)."""
    threads: int
    smem: int                 # bytes a block: dynamic, or static for K4
    grid: Tuple[int, int, int]
    fits: bool                # the kernel module's own verdict
    k_tile: int | None = None
    geometry: tuple | None = None
    static_smem: bool = False


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One plan target: `plan()` builds the launch the host would make
    (raising where it cannot); `out_dtype` is what the kernel must write."""
    name: str
    kernel: str
    n_bits: int
    plan: Callable[[], Launch]
    out_dtype: str


def representative_tilings(n_bits: int) -> Dict[str, Tuple[Tuple[int, int,
                                                                  int],
                                                            Tiling]]:
    """label -> ((M, N, K), Tiling): the launch plan K1 runs each bucket
    under at this width (k_tile pinned to the numerics default, as
    `tiling="auto"` serves it)."""
    M, N, K = STATIC_SHAPE
    kt = pinned_k_tile(MATMUL_TILING["k_tile"], n_bits)
    static = k12.launch_plan(M, N, K, n_bits, k_tile=kt,
                             bm=MATMUL_TILING["block_m"],
                             bn=MATMUL_TILING["block_n"])
    out = {"static": (STATIC_SHAPE, Tiling(kt, static.bm, static.bn,
                                           static.tb))}
    for label, shape in BUCKETS.items():
        out[label] = (shape, heuristic_tiling(*shape, n_bits))
    return out


def matmul_launch(shape, n: int, t: Tiling, host: bool, vec: bool
                   ) -> Launch:
    M, N, K = shape
    knobs = dict(bm=t.block_m, bn=t.block_n, tb=t.tb)
    if host and not k12.fits(n, True, vec, *knobs.values()):
        knobs = {}                 # olm_matmul re-plans K2's larger stage
    p = k12.launch_plan(M, N, K, n, k_tile=t.k_tile, host=host, vec=vec,
                        **knobs)
    return Launch(p.threads, p.smem, p.launch_grid,
                  k12.fits(n, host, vec, p.bm, p.bn, p.tb), p.kt,
                  (n, host, vec, p.bm, p.bn, p.tb, tree_levels(p.kt)))


def _dot_launch(n: int, K: int, vec: bool, general: bool = False,
                wide: bool = False) -> Launch:
    p = k3.launch_plan(DOT_B, K, n, vec, general=general)
    return Launch(k3.THREADS, p.smem, (p.grid, 1, 1),
                  p.smem <= k3.SMEM_PER_BLOCK,
                  geometry=(n, vec, p.rows, tree_levels(K), general, wide))


def _mul_launch(n: int) -> Launch:
    smem = k4.static_smem(n)
    return Launch(k4.ROWS, smem, (-(-MUL_B // k4.ROWS), 1, 1),
                  smem <= k4.MAX_STATIC_SMEM, static_smem=True)


def _tpmm_launch(shape, n: int) -> Launch:
    M, N, K = shape
    D = num_planes_for(n, 4)
    levels = min(kept_levels(n, 4), 2 * D - 1)
    bm, bn = k5.tile_shape(M, D, levels)
    splits, _ = k5.split_plan(M, N, K, D, levels, 4)
    smem = k5.smem_bytes(M, D, levels)
    return Launch(k5.THREADS, smem, (-(-N // bn), -(-M // bm), splits),
                  smem <= k5.MAX_SMEM, geometry=(D, M, levels))


def _matmul_cases(label_n: str, work: int) -> list:
    cases = []
    for label, (shape, t) in representative_tilings(work).items():
        tag = f"{label_n}/{label}-k{t.k_tile}m{t.block_m}n{t.block_n}t{t.tb}"
        cases.append(KernelCase(
            f"matmul-fused/{tag}", "olm_matmul_fused", work,
            lambda s=shape, t=t: matmul_launch(s, work, t, False, False),
            OUT_DTYPES["olm_matmul_fused"]))
        for vec in ((False, True) if work % 4 == 0 else (False,)):
            cases.append(KernelCase(
                f"matmul-host/{tag}{'/vec' if vec else ''}",
                "olm_matmul_host", work,
                lambda s=shape, t=t, v=vec: matmul_launch(s, work, t, True,
                                                           v),
                OUT_DTYPES["olm_matmul_host"]))
    return cases


def iter_cases(widths: Tuple[int, ...] | None = None) -> list[KernelCase]:
    """Every registered kernel x width x bucket (K1/K2 also at each width's
    truncated olm{n}t{p} tiers, at their p working digits)."""
    widths = tuple(sorted(widths if widths is not None else MATMUL_MODES))
    cases: list[KernelCase] = []
    for n in widths:
        cases.extend(_matmul_cases(f"olm{n}", n))
        for nn, p in TRUNCATED_SPECS:
            if nn == n:
                cases.extend(_matmul_cases(f"olm{n}t{p}", p))
        if k4.route(OnlinePrecision(n=n)) == "unrolled":
            cases.append(KernelCase(
                f"online_mul/olm{n}/b{MUL_B}", "online_mul", n,
                lambda n=n: _mul_launch(n), OUT_DTYPES["online_mul"]))
        for K in DOT_KS:
            for vec in (False, True):
                cases.append(KernelCase(
                    f"online_dot/olm{n}/b{DOT_B}k{K}{'/vec' if vec else ''}",
                    "online_dot", n, lambda n=n, K=K, v=vec: _dot_launch(
                        n, K, v), OUT_DTYPES["online_dot"]))
        for K in ANY_KS:
            for vec in (False, True):
                for wide in (False, True):
                    cases.append(KernelCase(
                        f"online_dot_any/olm{n}/b{DOT_B}k{K}"
                        f"{'/vec' if vec else ''}{'/int64' if wide else ''}",
                        "online_dot_any", n,
                        lambda n=n, K=K, v=vec, w=wide: _dot_launch(
                            n, K, v, True, w), OUT_DTYPES["online_dot_any"]))
        if n % 4 == 0 and n // 4 <= 8:
            for label, shape in BUCKETS.items():
                cases.append(KernelCase(
                    f"tpmm/n{n}/{label}", "tpmm", n,
                    lambda s=shape, n=n: _tpmm_launch(s, n),
                    OUT_DTYPES["tpmm"]))
    return cases
