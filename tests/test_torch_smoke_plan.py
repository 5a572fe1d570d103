"""What `chip_smoke.py` holds on the card, read on the CPU in milliseconds.

The script runs only on a CUDA card, and its run has a budget
(`SMOKE_BUDGET_S`). A cut that keeps it inside the budget must not narrow
what a kernel is compared on, loosen a gate, or drop a phase: each
constant that decides a comparison, each gate and the phases `main()` runs
are held here at their values, so any such change has to edit this file.
"""
from __future__ import annotations

import ast
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke_plan", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load()

_GENERAL_CONFIGS = (
    {"n": 16, "delta": 4}, {"n": 16, "t": 3}, {"n": 16, "delta": 2, "t": 1},
    {"n": 16, "delta": 4, "truncated": False, "tail_gating": False},
    {"n": 8, "delta": 0}, {"n": 36}, {"n": 8, "delta": -1},
    {"n": 2, "delta": 0, "t": 5, "truncated": False}, {"n": 5, "t": 8},
    {"n": 24, "t": 1})
_SERVE_KN = ((2048, 8192), (2048, 2048), (2048, 1024), (8192, 2048),
             (2048, 92544))

# Every constant that decides a shape, a width, a configuration or a span
# of rows or columns at which a kernel is held against its plain version
# (or against the paper's scalar model).
COMPARED = {
    "RAGGED": (5, 70, 37),
    "DECODE_GEMV": (4, 2048, 8192),
    "PREFILL_GEMM": (64, 2048, 2048),
    "SERVE_KN": _SERVE_KN,
    "SERVE_SHAPES": tuple((M, K, N) for M in (4, 64) for K, N in _SERVE_KN),
    "K12_EDGES": ((5, 1, 37), (5, 3, 37), (5, 15, 37), (5, 17, 37),
                  (5, 33, 37), (1, 70, 1003), (5, 70, 1003), (17, 70, 1003),
                  (1, 8192, 3)),
    "K12_EDGE_MODES": ("olm16", "olm24", "olm32"),
    "TPMM_EDGES": ((1, 2048, 1003), (16, 2048, 1003), (17, 2048, 1003),
                   (4, 1, 37), (4, 31, 37), (4, 33, 37), (4, 8192, 1003),
                   (17, 8192, 1003)),
    "TPMM_ODD": (5, 2048, 1003),
    "TPMM_MODES": ("nbit", "full", "eq8"),
    "MUL_B": 1 << 20,
    "MUL_CASES": ((8, True), (16, True), (24, True), (32, True), (8, False),
                  (16, False), (24, False)),
    "DOT_B": 4096,
    "DOT_CASES": ((16, 8), (16, 16), (16, 32), (64, 8), (64, 16), (64, 32),
                  (256, 8), (256, 16), (256, 32)),
    "DOT_EDGES": tuple((4059, K, n, True) for K in (1, 3, 33, 1024)
                       for n in (8, 13, 16, 32))
    + ((4059, 256, 16, False), (4059, 33, 16, False)),
    "DOT_OFFSET": (1000, 33, 16),
    "GENERAL_CONFIGS": _GENERAL_CONFIGS,
    "GENERAL_DOT": tuple((K, kw) for K in (33, 2048)
                         for kw in _GENERAL_CONFIGS)
    + ((300, {"n": 16}), (1025, {"n": 16}), (2048, {"n": 16}),
       (5000, {"n": 16}), (1500, {"n": 32}), (65537, {"n": 32})),
    "LONG_B": 131,
    "LONG_CHECKS": tuple((131, K, n) for K in (1024, 1025, 4096, 8192)
                         for n in (16, 32)),
    "GENERAL_MUL_B": 65573,
    "GENERAL_DOT_B": 61,
    "UNHELD": {"n": 36, "delta": 1},
    "F6_CONFIGS": ({"n": 24, "delta": 2, "t": 4}, {"n": 28, "delta": 2, "t": 4},
                   {"n": 24, "delta": 3, "t": 4}),
    "F6_DOT": (256, {"n": 24, "delta": 2, "t": 4}, 256),
    "F6_UNHELD": {"n": 32, "delta": 2, "t": 5},
    "TALL": (524317, 16, 3),
    "TALL_ROWS": 64,
    "CHATGLM_KN": ((4096, 4096), (4096, 256), (4096, 13696), (13696, 4096),
                   (4096, 65024)),
    "CUT_KN": ((7168, 1024), (20480, 7168), (7168, 64000), (8192, 1024),
               (49152, 8192), (8192, 152064)),
    "K1_SLICE": 2048,
    "FAMILY_KN": {
        "recurrentgemma_9b": ((4096, 4096), (4096, 256), (4096, 12288),
                              (12288, 4096), (4096, 256000)),
        "mamba2_130m": ((768, 3352), (1536, 768), (768, 50280)),
        "mixtral_8x22b": ((6144, 6144), (6144, 1024), (6144, 32768)),
        "qwen3_moe_235b_a22b": ((4096, 4096), (4096, 256), (4096, 151936)),
    },
    "RG_ROWS": (7,),
    "WHOLE_N": 32768,
    "CROSS_KN": {
        "llama_3_2_vision_11b": ((4096, 1024), (4096, 14336), (14336, 4096),
                                 (4096, 128256)),
        "seamless_m4t_medium": ((1024, 1024), (1024, 4096), (4096, 1024),
                                (1024, 256256)),
    },
    "CROSS_ROWS_KN": {
        "llama_3_2_vision_11b": ((4096, 1024),),
        "seamless_m4t_medium": ((1024, 1024), (1024, 4096), (4096, 1024)),
    },
    "ENC_ROWS": 2048,
    "ENC_CHECK_ROWS": 64,
    "ORACLE_DOT": (64, 256, 16),
    "ORACLE_MUL": (256, 16),
}

# Every gate and limit of the partitioned and dry-run checks.
GATES = {
    "TP_LOGIT_TOL": 3e-2,
    "SHARD_DATA_LIMITS": {"loss": 2.5e-4, "grad_norm": 1e-3, "update": 5e-2},
    "SHARD_TP_LIMITS": {"loss": 2.5e-4, "grad_norm": 5e-3, "update": 5e-2},
    "SHARD_TP_PEAK": 0.6,
    "SHARD_WALK_TOL": 0.05,
    "DRYRUN_PEAK_TOL": 0.05,
    "DRYRUN_BOUND_SLACK": 1.05,
}

# The shapes the time phase times the general and long-row K3/K4 routes
# at: the before-and-after lines of PERF.md.
TIMED = {
    "GENERAL_TIMED": ((None, {"n": 16, "delta": 4}, 1 << 20),
                      (None, {"n": 24, "t": 1}, 1 << 20),
                      (None, {"n": 24, "delta": 2, "t": 4}, 1 << 20),
                      (256, {"n": 16, "delta": 4}, 4096),
                      (256, {"n": 24, "delta": 2, "t": 4}, 4096),
                      (2048, {"n": 16}, 512)),
    "LONG_TIMED": ((512, 2048, 16), (512, 2048, 32), (128, 8192, 16),
                   (128, 8192, 32)),
}

PHASES = ["device", "build", "lint", "check", "time", "serve", "paths",
          "replay", "dense", "families", "tune", "crossattn", "train",
          "shard", "tp", "examples", "dryrun"]


@pytest.mark.parametrize("name", sorted(COMPARED))
def test_a_comparison_constant_keeps_its_value(name):
    assert getattr(SMOKE, name) == COMPARED[name]


@pytest.mark.parametrize("name", sorted(GATES))
def test_a_gate_keeps_its_value(name):
    assert getattr(SMOKE, name) == GATES[name]


@pytest.mark.parametrize("name", sorted(TIMED))
def test_a_timed_shape_keeps_its_value(name):
    assert getattr(SMOKE, name) == TIMED[name]


def test_the_budget_is_1000_s():
    assert SMOKE.SMOKE_BUDGET_S == 1000


def _main_phases():
    tree = ast.parse(SCRIPT.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "phase"]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [n.args[0].value for n in calls
            if isinstance(n.args[0], ast.Constant)]


def test_main_runs_every_phase_in_order():
    assert _main_phases() == PHASES + [None]


def test_the_docstring_lists_the_phases_main_runs():
    listed = re.findall(r"^ *\d+b?\. +(\w+) +-", SMOKE.__doc__, re.M)
    assert listed == PHASES


def test_loading_the_script_imports_neither_torch_nor_jax():
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('s', {str(SCRIPT)!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro', "
            "'repro_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=60)
    assert out.stdout.strip() == "[]"
