"""Contract registry and the Violation record every olmlint engine of the
port emits (port of `repro/analysis/contracts.py`).

A *contract* is one statically checkable invariant the paper's correctness
story rests on. Each has a stable id (the key below) that failures are
reported under: the tests assert on these ids, the CLI
(`tools/olmlint_torch.py`) prints them, and the AST suppression baseline
keys off them.

The reference's ids are kept where the invariant is the same:
`int32-overflow`, `decode-window`, `ast-raw-dot`,
`ast-transcendental-scale` and `ast-serving-contraction`. Its
`vmem-budget` becomes `launch-budget` (Hopper's shared memory, threads
and grid), and its jaxpr contracts become contracts on the SASS the CUDA
sources compile to (`kernel-no-transcendental`, `kernel-no-ftz`,
`kernel-no-f32-atomic`) and on the dtype each kernel writes
(`kernel-accum-dtype`). Not ported, each for a reason:

  kernel-no-int64    the port's int64 lanes are deliberate: `lane_bits`
                     sends a configuration whose residual may leave int32
                     to a 64-bit lane, and the stream decode past 24
                     digits accumulates in 64 bits.
  kernel-no-1d-iota  a TPU lowering rule; CUDA has no such construct.
  ast-x64-config     torch has no global x64 switch to flip.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Violation", "CONTRACTS"]

CONTRACTS = {
    # -- kernel engine: SASS contracts (repro_torch.analysis.sass) --
    "kernel-no-transcendental": (
        "No MUFU transcendental (EX2, LG2, SIN, COS, TANH, RSQ, SQRT) in "
        "a kernel's SASS: pow2 scales and decode weights are built by "
        "exponent-field bitcast, never a special-function unit whose ulp "
        "wobble breaks kernel/plain-version bit-identity (MUFU.RCP is the "
        "seed of IEEE division and stays legal)."),
    "kernel-no-ftz": (
        "No .FTZ modifier on an instruction with a float result: the "
        "builds use no fast-math, and subnormal operands are flushed "
        "explicitly before a scale is taken, as the reference's backends "
        "do (F2I's integer result is the same with or without it)."),
    "kernel-no-f32-atomic": (
        "No F32 RED or ATOM add in K1 and K2: their f32 accumulator must "
        "be bit-identical, and an atomic f32 sum changes order run to run "
        "(K5's exact int32 level sums stay legal)."),
    "kernel-accum-dtype": (
        "Kernel outputs carry the declared dtype (int32 digit streams, "
        "float32 matmul accumulators): a widened or narrowed output "
        "silently changes numerics."),
    # -- kernel engine: overflow prover (repro_torch.analysis.overflow) --
    "int32-overflow": (
        "Worst-case magnitude propagation through the Fig. 7 truncation "
        "schedule (paper Eq. 8: p = ceil((2n+delta+t)/3)) must prove "
        "every architectural quantity of the digit recurrence fits int32 "
        "for each (n_bits, k_tile) in the autotuner's legal range."),
    "decode-window": (
        "Dot-stream length n + 2*ceil(log2 k_tile) must stay inside the "
        "width's exact decode window (24 digits plain-f32, 48 wide "
        "two-limb) - past it the decode silently rounds and the "
        "three-path bit-identity breaks."),
    # -- kernel engine: launch budget (repro_torch.analysis.smem) --
    "launch-budget": (
        "Each launch plan must be one Hopper launches: its block shape "
        "legal for the kernel, threads a multiple of 32 and at most the "
        "kernel's maximum, dynamic shared memory within 227 KB (232,448 "
        "bytes) a block, grid y within 65,535, k_tile within the kernel's "
        "tree and the width's decode window; on the card, the shared "
        "memory the kernel asks for equals the plan's and an SM holds at "
        "least one block."),
    # -- AST engine (repro_torch.analysis.ast_lint) --
    "ast-raw-dot": (
        "No raw torch.dot / torch.mm / torch.addmm / "
        "torch.nn.functional.linear outside core/numerics.py: every GEMM "
        "a DotEngine replaces routes through it, so mode dispatch and the "
        "olm bit-identity guarantees cannot be bypassed."),
    "ast-transcendental-scale": (
        "No math.log2 / exp2 / pow, numpy.exp2 / log2 / power or "
        "torch.exp2 / log2 / pow / exp / log in scale-computation modules: "
        "pow2 scales are built by exponent-field bitcast so they are exact "
        "powers of two on every backend."),
    "ast-serving-contraction": (
        "No contraction (the raw-dot set plus einsum / matmul / bmm / "
        "tensordot / inner / vdot and the @ operator) inside "
        "repro_torch/serving/: the serving engine is a scheduler, and "
        "every GEMM goes through the model so the deployment's dot_mode "
        "governs all serving math."),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract failure: the contract id, where it was found (kernel
    case name or file:line), and the offending evidence (SASS line, AST
    source line, or the numbers that broke the bound)."""

    contract: str
    where: str
    detail: str

    def __str__(self) -> str:
        text = CONTRACTS.get(self.contract, "(unknown contract)")
        return (f"[{self.contract}] {self.where}\n"
                f"    {self.detail}\n"
                f"    contract: {text}")
