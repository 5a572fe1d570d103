"""Kernel engine core: each launch plan against Hopper's limits (port of
`repro/analysis/vmem.py`, whose VMEM footprint model becomes the plan's
shared memory, threads and grid).

For every registered case (`registry.iter_cases`) `check_plan` holds the
`launch-budget` contract on the CPU:

  * the plan builds (the planner raises where no block fits);
  * the kernel module's own verdict holds (`matmul_kernel.fits` for K1/K2,
    the shared memory limit for K3-K5);
  * threads a multiple of 32 and at most the kernel's maximum;
  * shared memory within SMEM_PER_BLOCK (227 KB dynamic; 48 KB static for
    K4's statically sized block);
  * grid y and z within 65,535 (K1/K2 continue row blocks past it in z);
  * k_tile within K1/K2's tree (`MAX_K_TILE`) and the width's exact decode
    window (`tuning.max_k_tile`).

`check_tuning_cache` holds every entry of the committed
`results/tuning_torch.json` to the same checks for K1 (the plan the entry
pins, at its working digits and shape), as the reference's
`vmem.check_tuning_cache` does for `results/tuning.json`: a stale or
hand-edited cache that would steer K1 off the card's limits fails lint
before it fails on the card.

The card's half runs in `chip_smoke.py`'s lint phase: `check_geometry`
holds each K1, K2, K3 and K5 plan's shared memory equal to what the
compiled kernel asks for (each source's `geometry` query; K3's answers
for both its kernels, the general one in each residual datapath) and asks
that an SM hold a block; `check_static_smem` holds K4's host count
(`static_smem`) equal to the static shared memory ptxas reports for each
online_mul_kernel<n> instance. The limits are the kernel modules' own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterable

from repro_torch.kernels.online_dot import kernel as k3
from repro_torch.kernels.online_dot import matmul_kernel as k12
from repro_torch.kernels.online_dot.tuning import (DEFAULT_CACHE_PATH,
                                                   Tiling, max_k_tile)
from repro_torch.kernels.online_mul import kernel as k4
from repro_torch.kernels.tpmm import kernel as k5

from .contracts import Violation
from .registry import KernelCase, Launch, matmul_launch, iter_cases

__all__ = ["SMEM_PER_BLOCK", "STATIC_SMEM", "MAX_GRID_YZ", "MAX_THREADS",
           "check_launch", "check_plan", "check_tuning_cache",
           "tuning_cases", "check_geometry", "check_static_smem", "run"]

SMEM_PER_BLOCK = k12.SMEM_PER_BLOCK    # the most dynamic shared memory
STATIC_SMEM = k4.MAX_STATIC_SMEM       # the most static shared memory
MAX_GRID_YZ = k12.MAX_GRID_Y
MAX_THREADS = {"olm_matmul_fused": k12.MAX_THREADS,
               "olm_matmul_host": k12.MAX_THREADS,
               "online_dot": k3.THREADS, "online_dot_any": k3.THREADS,
               "online_mul": k4.ROWS,
               "tpmm": k5.THREADS}


def check_launch(kernel: str, n_bits: int, p: Launch, *, where: str
                 ) -> list[Violation]:
    """The launch-budget (and, for K1/K2, decode-window) checks of one
    built launch."""
    out: list[Violation] = []

    def bad(detail, contract="launch-budget"):
        out.append(Violation(contract, where, detail))

    if not p.fits:
        bad(f"the kernel module refuses its own plan ({p})")
    if p.threads % 32 or not 32 <= p.threads <= MAX_THREADS[kernel]:
        bad(f"{p.threads} threads a block: not a multiple of 32 in "
            f"[32, {MAX_THREADS[kernel]}]")
    limit = STATIC_SMEM if p.static_smem else SMEM_PER_BLOCK
    if p.smem > limit:
        bad(f"{p.smem} bytes of {'static' if p.static_smem else 'dynamic'} "
            f"shared memory a block exceeds {limit}")
    if max(p.grid[1:]) > MAX_GRID_YZ or min(p.grid) < 1:
        bad(f"grid {p.grid}: y and z must lie in [1, {MAX_GRID_YZ}]")
    if p.k_tile is not None:
        cap = min(k12.MAX_K_TILE, max_k_tile(n_bits))
        if p.k_tile > cap:
            bad(f"k_tile {p.k_tile} exceeds min(MAX_K_TILE "
                f"{k12.MAX_K_TILE}, max_k_tile({n_bits}) "
                f"{max_k_tile(n_bits)}) = {cap}", "decode-window")
    return out


def check_plan(case: KernelCase) -> list[Violation]:
    """Build one case's plan and check it; a plan that does not build is a
    violation too."""
    try:
        p = case.plan()
    except ValueError as e:
        return [Violation("launch-budget", case.name,
                          f"the planner refuses the case: {e}")]
    return check_launch(case.kernel, case.n_bits, p, where=case.name)


def tuning_cases(path: str | None = None) -> list[KernelCase]:
    """One K1 case per entry of the tuning cache: the plan the entry pins
    at its working digits (`trunc` where present) and its shape."""
    path = path or DEFAULT_CACHE_PATH
    if not os.path.exists(path):
        return []
    with open(path) as f:
        entries = json.load(f).get("entries", {})
    cases = []
    for key, e in sorted(entries.items()):
        work = int(e.get("trunc") or e["n_bits"])
        t = Tiling(int(e["k_tile"]), int(e["block_m"]), int(e["block_n"]),
                   int(e["tb"]))
        cases.append(KernelCase(
            f"tuning-cache {os.path.basename(path)}::{key}",
            "olm_matmul_fused", work,
            lambda s=tuple(e["shape"]), t=t, w=work: _pinned_launch(s, w, t),
            "float32"))
    return cases


def _pinned_launch(shape, work: int, t: Tiling) -> Launch:
    """K1's launch under an entry's pinned plan, exactly as pinned: a knob
    the planner would halve to fit is the entry's fault, not a plan. The
    entry's own k_tile is reported (the plan is built at the most K1's
    tree takes), so an oversized one fails the decode-window check."""
    if not k12.fits(work, False, False, t.block_m, t.block_n, t.tb):
        raise ValueError(f"block {t.block_m} x {t.block_n} x {t.tb} does not "
                         f"fit K1 at n={work}")
    fit = dataclasses.replace(t, k_tile=min(t.k_tile, k12.MAX_K_TILE))
    return dataclasses.replace(
        matmul_launch(shape, work, fit, False, False), k_tile=t.k_tile)


def check_tuning_cache(path: str | None = None) -> list[Violation]:
    """Validate every tuning-cache entry against the same checks."""
    out: list[Violation] = []
    for case in tuning_cases(path):
        out.extend(check_plan(case))
    return out


def check_geometry(case: KernelCase, geometry) -> list[Violation]:
    """The card's half, in the lint phase: the shared memory the kernel
    asks for at the plan (`geometry(*launch.geometry)` -> (bytes, blocks an
    SM holds)) must equal the plan's, and an SM must hold a block."""
    p = case.plan()
    if p.geometry is None:
        return []
    smem, blocks = geometry(*p.geometry)
    out = []
    if smem != p.smem:
        out.append(Violation(
            "launch-budget", case.name,
            f"the kernel asks for {smem} bytes of shared memory, the plan "
            f"counts {p.smem}"))
    if blocks < 1:
        out.append(Violation(
            "launch-budget", case.name,
            f"the card holds {blocks} blocks of the plan an SM"))
    return out


_MUL_INSTANCE = re.compile(r"online_mul_kernelILi(\d+)E")


def check_static_smem(report: dict) -> list[Violation]:
    """K4's card half: every online_mul_kernel<n> instance of a ptxas
    report of online_mul.cu (`sass.parse_ptxas`) must hold the static
    shared memory `static_smem(n)` counts; a report without one is a
    violation too."""
    out, seen = [], 0
    for symbol, k in report.items():
        m = _MUL_INSTANCE.search(symbol)
        if m is None:
            continue
        seen += 1
        n = int(m.group(1))
        if k["smem"] != k4.static_smem(n):
            out.append(Violation(
                "launch-budget", f"online_mul.cu::online_mul_kernel<{n}>",
                f"ptxas reports {k['smem']} bytes of static shared memory, "
                f"static_smem({n}) counts {k4.static_smem(n)}"))
    if not seen:
        out.append(Violation("launch-budget", "online_mul.cu",
                             "the ptxas report holds no online_mul_kernel "
                             "instance"))
    return out


def run(widths: Iterable[int] | None = None,
        tuning_path: str | None = None) -> list[Violation]:
    """Check every registered width's cases and the committed tuning
    cache."""
    out: list[Violation] = []
    for case in iter_cases(tuple(widths) if widths is not None else None):
        out.extend(check_plan(case))
    out.extend(check_tuning_cache(tuning_path))
    return out
