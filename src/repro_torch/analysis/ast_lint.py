"""AST engine: repo architecture rules over `src/repro_torch/` (port of
`repro/analysis/ast_lint.py`).

Three rules (style is ruff's job):

  ast-raw-dot              no torch.dot / torch.mm / torch.addmm /
                           torch.nn.functional.linear outside
                           core/numerics.py: those are the forms a
                           DotEngine GEMM replaces, so routing them around
                           it would bypass the olm mode dispatch.
                           torch.matmul, torch.einsum, torch.bmm and @ stay
                           allowed outside serving, as the reference allows
                           jnp.matmul and einsum.
  ast-transcendental-scale no math.log2 / exp2 / pow, numpy.exp2 / log2 /
                           power or torch.exp2 / log2 / pow / exp / log in
                           the scale-computation modules: pow2 scales are
                           exponent-field bitcasts, exact on every backend.
  ast-serving-contraction  no contraction (the raw-dot set plus einsum,
                           matmul, bmm, tensordot, inner, vdot and the @
                           operator) inside src/repro_torch/serving/: the
                           serving engine is a scheduler, and every GEMM
                           goes through the model so the deployment's
                           dot_mode governs all serving math.

The reference's `ast-x64-config` has no counterpart: torch has no global
x64 switch. Import aliases are resolved per module (import torch.nn.
functional as F, from torch import mm, import numpy as np, ...) so renaming
an import cannot dodge a rule. Grandfathered sites live in a committed
suppression baseline (`tools/olmlint_torch_baseline.json`) keyed
`rule::relpath::qualname`: moving or adding a call invalidates its key, so
the baseline can only shrink silently, never grow.
"""
from __future__ import annotations

import ast
import json
import os

from .contracts import Violation

__all__ = ["RAW_DOT_CALLS", "TRANSCENDENTAL_CALLS", "SCALE_MODULES",
           "SERVING_CONTRACTION_CALLS", "SERVING_MODULES_PREFIX",
           "DEFAULT_BASELINE_PATH", "lint_file", "load_baseline",
           "baseline_key", "run"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_BASELINE_PATH = os.path.join(_REPO_ROOT, "tools",
                                     "olmlint_torch_baseline.json")

# Fully-qualified callables each rule bans (post alias resolution).
RAW_DOT_CALLS = frozenset({
    "torch.dot", "torch.mm", "torch.addmm", "torch.nn.functional.linear",
})
TRANSCENDENTAL_CALLS = frozenset({
    "math.log2", "math.exp2", "math.pow",
    "numpy.exp2", "numpy.log2", "numpy.power",
    "torch.exp2", "torch.log2", "torch.pow", "torch.exp", "torch.log",
})
SERVING_CONTRACTION_CALLS = RAW_DOT_CALLS | frozenset({
    "torch.einsum", "torch.matmul", "torch.bmm", "torch.tensordot",
    "torch.inner", "torch.vdot",
})

# repo-relative allowlists / scopes (posix-style paths)
SRC_ROOT = "src/repro_torch"
RAW_DOT_ALLOWED = ("src/repro_torch/core/numerics.py",)
SERVING_MODULES_PREFIX = "src/repro_torch/serving/"
# modules that compute or apply pow2 scales: the bit-exactness surface
SCALE_MODULES = (
    "src/repro_torch/kernels/common.py",
    "src/repro_torch/kernels/tpmm/quantize.py",
    "src/repro_torch/core/sd.py",
)


def _import_aliases(tree: ast.Module) -> dict:
    """name-in-module -> fully qualified dotted prefix."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level:      # relative imports never alias torch/numpy
                continue
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(func: ast.AST, aliases: dict) -> str | None:
    """Resolve a call's func node to a fully qualified dotted name."""
    parts: list[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = aliases.get(node.id, node.id)
    return ".".join([base, *reversed(parts)])


def baseline_key(rule: str, relpath: str, qualname: str) -> str:
    return f"{rule}::{relpath}::{qualname}"


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, aliases: dict):
        self.relpath = relpath
        self.aliases = aliases
        self.stack: list[str] = []
        self.findings: list[tuple[str, int, str]] = []  # (rule, line, qual)

    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _serving(self) -> bool:
        return self.relpath.startswith(SERVING_MODULES_PREFIX)

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func, self.aliases)
        if name:
            if (name in RAW_DOT_CALLS
                    and self.relpath not in RAW_DOT_ALLOWED):
                self.findings.append(("ast-raw-dot", node.lineno,
                                      self._qual()))
            if (name in TRANSCENDENTAL_CALLS
                    and self.relpath in SCALE_MODULES):
                self.findings.append(("ast-transcendental-scale",
                                      node.lineno, self._qual()))
            if name in SERVING_CONTRACTION_CALLS and self._serving():
                self.findings.append(("ast-serving-contraction",
                                      node.lineno, self._qual()))
        self.generic_visit(node)

    def _matmul_op(self, node):
        if isinstance(node.op, ast.MatMult) and self._serving():
            self.findings.append(("ast-serving-contraction", node.lineno,
                                  self._qual()))
        self.generic_visit(node)

    visit_BinOp = _matmul_op
    visit_AugAssign = _matmul_op


def lint_file(path: str, root: str | None = None
              ) -> list[tuple[str, str, int, str]]:
    """Lint one file; returns (rule, relpath, lineno, qualname) tuples
    (suppression not yet applied: `run` handles the baseline)."""
    root = root or _REPO_ROOT
    relpath = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    v = _Visitor(relpath, _import_aliases(tree))
    v.visit(tree)
    return [(rule, relpath, line, qual) for rule, line, qual in v.findings]


def load_baseline(path: str | None = None) -> set[str]:
    path = path or DEFAULT_BASELINE_PATH
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return set(json.load(f).get("suppressions", []))


def run(root: str | None = None, baseline: set[str] | str | None = None
        ) -> tuple[list[Violation], list[str], set[str]]:
    """Lint every .py under src/repro_torch/ of `root`.

    Returns (violations, raw_keys, unused_baseline): raw_keys is every
    finding's baseline key pre-suppression (what --write-baseline
    records); unused_baseline entries are stale suppressions worth pruning
    (reported, never fatal)."""
    root = os.path.abspath(root or _REPO_ROOT)
    if not isinstance(baseline, set):
        baseline = load_baseline(baseline)
    violations: list[Violation] = []
    raw_keys: list[str] = []
    used: set[str] = set()
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, SRC_ROOT)):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            for rule, relpath, line, qual in lint_file(
                    os.path.join(dirpath, fn), root):
                key = baseline_key(rule, relpath, qual)
                raw_keys.append(key)
                if key in baseline:
                    used.add(key)
                    continue
                violations.append(Violation(
                    rule, f"{relpath}:{line}",
                    f"in {qual} (suppress with baseline key {key!r} "
                    "only for grandfathered sites)"))
    return violations, raw_keys, baseline - used
