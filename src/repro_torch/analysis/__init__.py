"""olmlint for the port: static kernel-contract and numerics analyzer (port
of `repro/analysis/`).

Two engines over the port's correctness story:

  Kernel engine: the symbolic int32 non-overflow proof of the Fig. 7 /
    Eq. 8 schedule and the decode-window coverage of the autotuner's legal
    k_tile range (overflow, the reference's walk with the same answers);
    every registered kernel's launch plan at every width and shape bucket,
    and every entry of the committed tuning cache, against Hopper's
    launch limits (smem, the counterpart of vmem); and, where the card's
    build exists, the SASS contracts of each compiled CUDA source (sass,
    the counterpart of jaxpr_lint).

  AST engine: repo architecture rules over src/repro_torch/ with a
    committed suppression baseline (ast_lint).

CLI: tools/olmlint_torch.py. On the card, chip_smoke.py's lint phase runs
the SASS engine over the fresh build and holds every plan against the
card's own occupancy.
"""
from __future__ import annotations

from typing import Iterable

from . import ast_lint, overflow, sass, smem
from .contracts import CONTRACTS, Violation
from .registry import KernelCase, iter_cases

__all__ = ["CONTRACTS", "Violation", "KernelCase", "iter_cases",
           "run_kernel_lint", "run_ast_lint", "run_all"]


def run_kernel_lint(widths: Iterable[int] | None = None,
                    tuning_path: str | None = None) -> list[Violation]:
    """Kernel engine: overflow proof + launch plans, and the SASS contracts
    where the card's build of every source exists."""
    from repro_torch.kernels import build
    out: list[Violation] = []
    out.extend(overflow.run(widths))
    out.extend(smem.run(widths, tuning_path))
    if all(build.built_path(s).exists() for s in sass.SOURCES):
        out.extend(sass.run()[0])
    return out


def run_ast_lint(root: str | None = None,
                 baseline: set[str] | str | None = None
                 ) -> tuple[list[Violation], list[str], set[str]]:
    """AST engine. Returns (violations, raw keys, unused baseline entries);
    see ast_lint.run."""
    return ast_lint.run(root, baseline)


def run_all(widths: Iterable[int] | None = None,
            root: str | None = None,
            baseline: set[str] | str | None = None) -> list[Violation]:
    """Both engines; the CLI's default."""
    violations = run_kernel_lint(widths)
    ast_violations, _, _ = run_ast_lint(root, baseline)
    return violations + ast_violations
