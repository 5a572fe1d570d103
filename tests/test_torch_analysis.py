"""The port's static analyzer (`repro_torch.analysis`, `tools/
olmlint_torch.py`): the overflow prover and the decode windows equal to the
reference's (`repro.analysis.overflow`), every contract failing on a
fixture under its named id, the shipped plans and the committed tuning
cache clean, the AST rules (aliases included) and the repo clean under the
committed baseline, and the CLI's exit codes. The SASS engine's card half
runs in chip_smoke.py's lint phase; here it runs on text fixtures."""
import dataclasses
import importlib.util
import json
import pathlib
import warnings

import pytest

from repro.analysis import overflow as joverflow
from repro.core.precision import OnlinePrecision as JPrecision
from repro.kernels.online_dot import tuning as jtuning
from repro_torch.analysis import (ast_lint, overflow, registry, run_ast_lint,
                                  sass, smem)
from repro_torch.configs.olm_array import MATMUL_MODES, TRUNCATED_SPECS
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import matmul_kernel as k12
from repro_torch.kernels.online_dot import tuning
from repro_torch.kernels.tpmm import kernel as tpmm_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTHS = tuple(sorted(MATMUL_MODES))


def _contracts(violations):
    return {v.contract for v in violations}


def _both(kw):
    """(the reference's answer, the port's) for one configuration: the
    prover's (bits, detail), or the exception type where it raises."""
    out = []
    for make, prove in ((JPrecision, joverflow.prove_schedule),
                        (OnlinePrecision, overflow.prove_schedule)):
        try:
            out.append(prove(make(**kw)))
        except ValueError as e:
            out.append(type(e))
    return out


# ------------------------------------------------- the prover, held equal

@pytest.mark.parametrize("n", WIDTHS)
def test_prover_equals_the_reference_at_every_width(n):
    ref, port = _both(dict(n=n))
    assert port == ref and port[0] <= 31


@pytest.mark.parametrize("n,p", TRUNCATED_SPECS)
def test_prover_equals_the_reference_at_every_truncated_tier(n, p):
    ref, port = _both(dict(n=p))
    assert port == ref and port[0] <= 31


@pytest.mark.parametrize("n", range(4, 33))
def test_prover_equals_the_reference_over_the_sweep(n):
    for delta in range(1, 6):
        for t in range(1, 6):
            if n <= delta:
                continue
            ref, port = _both(dict(n=n, delta=delta, t=t))
            assert port == ref, (n, delta, t)


@pytest.mark.parametrize("n", WIDTHS)
def test_decode_windows_and_k_tiles_equal_the_reference(n):
    assert tuning.max_k_tile(n) == jtuning.max_k_tile(n)
    assert tuning.decode_window(n) == jtuning.decode_window(n)
    got = overflow.check_decode_windows(n, where=f"decode/olm{n}")
    want = joverflow.check_decode_windows(n, where=f"decode/olm{n}")
    assert got == [] and [dataclasses.astuple(v) for v in want] == []


def test_max_k_tiles_at_the_registered_widths():
    assert [tuning.max_k_tile(n) for n in WIDTHS] == [256, 16, 4096, 256]


def test_overflow_run_equals_the_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = joverflow.run()
    assert overflow.run() == [] and want == []


def test_adder_tree_digit_bound_is_one():
    assert overflow.adder_tree_digit_bound() == 1
    assert joverflow.adder_tree_digit_bound() == 1


# ---------------------------------------------------------------- fixtures

def test_fixture_overflowing_schedule_fails_named_contract():
    kw = dict(n=24, delta=2, t=4)
    got = overflow.check_schedule(OnlinePrecision(**kw), where="fixture")
    want = joverflow.check_schedule(JPrecision(**kw), where="fixture")
    assert _contracts(got) == {"int32-overflow"}
    assert [dataclasses.astuple(v) for v in got] == \
        [dataclasses.astuple(v) for v in want]
    assert "WRONGLY accepts" in got[0].detail


def _launch(**kw):
    base = dict(threads=128, smem=1024, grid=(4, 4, 1), fits=True,
                k_tile=16)
    base.update(kw)
    return registry.Launch(**base)


@pytest.mark.parametrize("kw,contract", [
    (dict(smem=smem.SMEM_PER_BLOCK + 16), "launch-budget"),
    (dict(threads=96 + 8), "launch-budget"),
    (dict(threads=512), "launch-budget"),
    (dict(grid=(4, 65536, 1)), "launch-budget"),
    (dict(fits=False), "launch-budget"),
    (dict(k_tile=32), "decode-window"),
])
def test_fixture_over_budget_plan_fails_named_contract(kw, contract):
    vs = smem.check_launch("olm_matmul_fused", 16, _launch(**kw),
                           where="fixture")
    assert _contracts(vs) == {contract}


def test_fixture_oversized_k_tile_at_a_narrow_window():
    # olm24 decodes 4096 lanes exactly, but K1's tree holds 16
    vs = smem.check_launch("olm_matmul_fused", 24, _launch(k_tile=64),
                           where="fixture")
    assert _contracts(vs) == {"decode-window"}
    assert smem.check_launch("olm_matmul_fused", 24, _launch(k_tile=16),
                             where="fixture") == []


def test_fixture_static_shared_memory_over_48k():
    p = _launch(smem=48 * 1024 + 4, static_smem=True, k_tile=None)
    assert _contracts(smem.check_launch("online_mul", 16, p,
                                        where="fixture")) == {"launch-budget"}


def test_fixture_plan_that_does_not_build():
    def refuse():
        raise ValueError("no block fits")
    case = registry.KernelCase("fixture", "olm_matmul_fused", 16, refuse,
                               "float32")
    assert _contracts(smem.check_plan(case)) == {"launch-budget"}


def test_fixture_poisoned_tuning_cache_fails(tmp_path):
    entries = json.loads((ROOT / "results" / "tuning_torch.json")
                         .read_text())["entries"]
    key, good = sorted(entries.items())[0]
    poisoned = {"entries": {
        "threads": dict(good, block_m=64, block_n=64, tb=1),
        "k_tile": dict(good, k_tile=32),
        key: good}}
    path = tmp_path / "tuning_torch.json"
    path.write_text(json.dumps(poisoned))
    vs = smem.check_tuning_cache(str(path))
    assert {v.where.rsplit("::", 1)[1] for v in vs} == {"threads", "k_tile"}
    assert _contracts(vs) == {"launch-budget", "decode-window"}


def test_committed_tuning_cache_clean():
    cases = smem.tuning_cases()
    assert len(cases) == 66
    assert smem.check_tuning_cache() == []


def test_row_blocks_past_grid_y_continue_in_z():
    # the cache's 1,048,576-row buckets: 131,072 row blocks of 8 rows
    p = k12.launch_plan(1 << 20, 1024, 1024, 16, bm=8, bn=16, tb=2)
    assert p.grid_y == 131072 and p.launch_grid == (64, 65535, 3)
    assert smem.check_launch("olm_matmul_fused", 16,
                             registry.matmul_launch(
                                 (1 << 20, 1024, 1024), 16,
                                 tuning.Tiling(16, 8, 16, 2), False, False),
                             where="fixture") == []


@pytest.mark.parametrize("n", WIDTHS)
def test_registered_plans_fit_hopper(n):
    cases = registry.iter_cases((n,))
    assert {c.kernel for c in cases} == set(registry.OUT_DTYPES)
    for case in cases:
        assert smem.check_plan(case) == [], case.name


def test_buckets_are_the_references():
    # the reference's representative_tilings asks its heuristic for these
    # labels and shapes; the port keeps them (its tilings differ by design)
    from repro.analysis import registry as jregistry
    asked = []

    def spy(M, N, K, n_bits):
        asked.append((M, N, K))
        return jtuning.heuristic_tiling(M, N, K, n_bits)

    real = jregistry.heuristic_tiling
    jregistry.heuristic_tiling = spy
    try:
        want = jregistry.representative_tilings(16)
    finally:
        jregistry.heuristic_tiling = real
    assert tuple(asked) == tuple(registry.BUCKETS.values())
    got = registry.representative_tilings(16)
    assert set(want) <= set(got) == {"static", *registry.BUCKETS}


def test_geometry_check_compares_the_cards_answer():
    case = registry.iter_cases((16,))[0]
    p = case.plan()
    assert smem.check_geometry(case, lambda *a: (p.smem, 2)) == []
    assert _contracts(smem.check_geometry(
        case, lambda *a: (p.smem + 16, 0))) == {"launch-budget"}


# ------------------------------------------------------------ SASS fixtures

SASS = """
        code for sm_90a
                Function : _Z16olm_matmul_kernelILi16ELb0ELb0EjEv4Args
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.RCP R3, R2 ;
        /*0020*/                   MUFU.EX2 R4, R5 ;
        /*0030*/              @!P0 FADD.FTZ R6, R6, R7 ;
        /*0040*/                   FFMA R6, R6, R7, R8 ;
        /*0050*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R9 ;
        /*0060*/                   RED.E.ADD.STRONG.GPU [R2.64], R9 ;
        /*0068*/                   F2I.FTZ.U32.TRUNC.NTZ R3, R2 ;
        /*0070*/                   EXIT ;
"""


def test_fixture_sass_flags_each_contract():
    vs = sass.check_sass(SASS, "olm_matmul.cu")
    by = {}
    for v in vs:
        by.setdefault(v.contract, []).append(v.detail)
    assert set(by) == {"kernel-no-transcendental", "kernel-no-ftz",
                       "kernel-no-f32-atomic"}
    assert len(by["kernel-no-transcendental"]) == 1
    assert "MUFU.EX2" in by["kernel-no-transcendental"][0]
    # FADD.FTZ and the RED; F2I.FTZ (integer division's) is no float result
    assert len(by["kernel-no-ftz"]) == 2
    assert len(by["kernel-no-f32-atomic"]) == 1
    assert "/*0020*/" in [v for v in vs
                          if v.contract == "kernel-no-transcendental"][0].where


def test_fixture_sass_int_atomics_legal_in_tpmm():
    text = SASS.replace("MUFU.EX2 R4, R5", "IADD3 R4, R5, R6, RZ").replace(
        "FADD.FTZ", "FADD").replace("RED.E.ADD.F32.FTZ.RN.STRONG.GPU",
                                    "RED.E.ADD.STRONG.GPU")
    assert sass.check_sass(text, "tpmm.cu") == []
    assert sass.check_sass(text, "olm_matmul.cu") == []


def test_fixture_f32_atomic_legal_outside_k1_k2_but_not_ftz():
    vs = sass.check_sass(SASS, "tpmm.cu")
    assert "kernel-no-f32-atomic" not in _contracts(vs)


SLOWPATH = """
                Function : _Z16olm_matmul_kernelILi16ELb0ELb0EjEv4Args
        /*0000*/                   MUFU.RCP R34, R27 ;
        /*0010*/                   FCHK P0, R2, R27 ;
        /*0020*/                   FFMA R33, R34, -R27, 1 ;
        /*0030*/              @!P0 BRA 0x60 ;
        /*0040*/                   MOV R34, 0x60 ;
        /*0050*/                   CALL.REL.NOINC 0x80 ;
        /*0060*/                   FMUL R33, R33, 65536 ;
        /*0070*/                   EXIT ;
        /*0080*/                   FSETP.GTU.FTZ.AND P1, PT, |R27|, +INF , PT ;
        /*0090*/                   MUFU.RSQ R33, -QNAN ;
        /*00a0*/                   FADD.FTZ R39, -R37, -RZ ;
        /*00b0*/                   RET.REL.NODEC R34 0x0 ;
        /*00c0*/                   FADD.FTZ R40, R41, R42 ;
"""


def test_fixture_ieee_division_slow_path_exempt():
    # the subroutine FCHK sends a division's special operands to is the
    # compiler's IEEE division; an FTZ after its RET is not
    vs = sass.check_sass(SLOWPATH, "olm_matmul.cu")
    assert [v.where.split()[-1] for v in vs] == ["/*00c0*/"]
    assert len(sass.division_slowpath(SLOWPATH)) == 4
    # the same subroutine called with no FCHK before it is held to the rules
    plain = SLOWPATH.replace("FCHK P0, R2, R27", "IADD3 R2, R2, 1, RZ")
    assert _contracts(sass.check_sass(plain, "olm_matmul.cu")) == {
        "kernel-no-ftz", "kernel-no-transcendental"}
    assert len(sass.check_sass(plain, "olm_matmul.cu")) == 4


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 33792 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPi' for 'sm_90a'
ptxas info    : Function properties for _Z3barPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 384 bytes cmem[0]
"""


def test_fixture_ptxas_log_parsed():
    assert sass.parse_ptxas(PTXAS) == {
        "_Z3fooPi": dict(registers=40, spill_stores=8, spill_loads=12,
                         smem=33792),
        "_Z3barPi": dict(registers=255, spill_stores=0, spill_loads=0,
                         smem=0)}


MUL_PTXAS = """ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__cea2dc47_13_online_mul_cu_68aca02f17online_mul_kernelILi32EEEvPKiS2_PixiN3olm5SchedE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__cea2dc47_13_online_mul_cu_68aca02f17online_mul_kernelILi32EEEvPKiS2_PixiN3olm5SchedE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 33792 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__cea2dc47_13_online_mul_cu_68aca02f17online_mul_kernelILi16EEEvPKiS2_PixiN3olm5SchedE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__cea2dc47_13_online_mul_cu_68aca02f17online_mul_kernelILi16EEEvPKiS2_PixiN3olm5SchedE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 17408 bytes smem, 400 bytes cmem[0]
"""


def test_fixture_k4_static_smem_against_ptxas():
    # K4's host count of its static shared memory against what ptxas
    # reports for each online_mul_kernel<n> (n | 1 words a row, 128 rows)
    report = sass.parse_ptxas(MUL_PTXAS)
    assert smem.check_static_smem(report) == []
    vs = smem.check_static_smem(
        sass.parse_ptxas(MUL_PTXAS.replace("17408 bytes", "16384 bytes")))
    assert [v.where for v in vs] == ["online_mul.cu::online_mul_kernel<16>"]
    assert _contracts(smem.check_static_smem(
        sass.parse_ptxas(PTXAS))) == {"launch-budget"}


@pytest.mark.parametrize("op,held", [
    ("F2I.FTZ.U32.TRUNC.NTZ", False), ("F2I.FTZ.S32", False),
    ("F2I.FTZ.FLOOR.NTZ", True), ("F2I.FTZ.CEIL.NTZ", True),
    ("F2I.S32.FLOOR.NTZ", False)])
def test_fixture_f2i_ftz_exempt_only_where_the_flush_cannot_change_it(
        op, held):
    # a subnormal truncates or rounds to 0 with or without the flush, but
    # floors (or ceils) to -1 (1) unflushed: only those forms are held
    text = SASS.split("/*0010*/")[0] + f"        /*0010*/  {op} R3, R2 ;\n"
    vs = sass.check_sass(text, "online_mul.cu")
    assert _contracts(vs) == ({"kernel-no-ftz"} if held else set())


def test_k5_plans_are_held_against_the_cards_geometry():
    # every registered tpmm plan names its (D, M, levels) geometry query,
    # so the lint phase holds its shared memory against the card's
    cases = [c for c in registry.iter_cases() if c.kernel == "tpmm"]
    assert cases
    for case in cases:
        p = case.plan()
        D, M, levels = p.geometry
        assert p.smem == tpmm_kernel.smem_bytes(M, D, levels)
        assert smem.check_geometry(case, lambda *a: (p.smem, 1)) == []
        assert _contracts(smem.check_geometry(
            case, lambda *a: (p.smem - 64, 1))) == {"launch-budget"}


def test_fixture_output_dtype():
    assert sass.check_dtype("olm_matmul_fused", "torch.float32",
                            where="f") == []
    assert _contracts(sass.check_dtype("online_dot", "torch.int64",
                                       where="f")) == {"kernel-accum-dtype"}


def test_sass_engine_refuses_without_a_build(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no build"):
        sass.run()


# ------------------------------------------------------------ the AST rules

def _lint_src(tmp_path, rel, source):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return [(r, q) for r, _, _, q in ast_lint.lint_file(str(p),
                                                          str(tmp_path))]


@pytest.mark.parametrize("source", [
    "import torch\ndef f(a, b):\n    return torch.mm(a, b)\n",
    "import torch as T\ndef f(a, b):\n    return T.dot(a, b)\n",
    "from torch import addmm as am\ndef f(c, a, b):\n    return am(c, a, b)\n",
    "import torch.nn.functional as F\ndef f(a, w):\n    return F.linear(a, w)\n",
    "from torch.nn import functional\n"
    "def f(a, w):\n    return functional.linear(a, w)\n",
])
def test_ast_raw_dot_flagged_through_aliases(tmp_path, source):
    assert _lint_src(tmp_path, "src/repro_torch/models/new_layer.py",
                     source) == [("ast-raw-dot", "f")]


def test_ast_raw_dot_allowed_in_numerics(tmp_path):
    assert _lint_src(tmp_path, "src/repro_torch/core/numerics.py",
                     "import torch\ndef f(a, b):\n"
                     "    return torch.mm(a, b)\n") == []


def test_ast_matmul_einsum_and_matmul_op_fine_outside_serving(tmp_path):
    assert _lint_src(tmp_path, "src/repro_torch/models/new_layer.py",
                     "import torch\ndef f(a, b):\n"
                     "    return torch.einsum('ij,jk', a, b) + a @ b"
                     " + torch.matmul(a, b) + torch.bmm(a, b)\n") == []


@pytest.mark.parametrize("source,rules", [
    ("import torch\ndef f(a, b):\n    return torch.einsum('ij,jk', a, b)\n",
     ["ast-serving-contraction"]),
    ("def f(a, b):\n    return a @ b\n", ["ast-serving-contraction"]),
    ("def f(a, b):\n    a @= b\n    return a\n",
     ["ast-serving-contraction"]),
    ("from torch import tensordot as td\ndef f(a, b):\n"
     "    return td(a, b)\n", ["ast-serving-contraction"]),
    ("import torch\ndef f(a, b):\n    return torch.mm(a, b)\n",
     ["ast-raw-dot", "ast-serving-contraction"]),
])
def test_ast_serving_contraction_flagged(tmp_path, source, rules):
    found = _lint_src(tmp_path, "src/repro_torch/serving/sched.py", source)
    assert sorted(r for r, _ in found) == rules


@pytest.mark.parametrize("source", [
    "import math\ndef f(x):\n    return math.log2(x)\n",
    "from math import exp2 as e\ndef f(x):\n    return e(x)\n",
    "import numpy as np\ndef f(x):\n    return np.power(2.0, x)\n",
    "import torch\ndef f(x):\n    return torch.exp(x)\n",
    "from torch import pow as p\ndef f(x):\n    return p(2.0, x)\n",
])
def test_ast_transcendental_scale_flagged(tmp_path, source):
    assert _lint_src(tmp_path, "src/repro_torch/kernels/common.py",
                     source) == [("ast-transcendental-scale", "f")]
    assert _lint_src(tmp_path, "src/repro_torch/models/other.py",
                     source) == []


def test_ast_repo_clean_under_committed_baseline():
    violations, raw, unused = run_ast_lint()
    assert violations == [], "\n".join(str(v) for v in violations)
    assert unused == set(), f"stale baseline suppressions: {sorted(unused)}"
    # the grandfathered sites: the two the reference also keeps, and no
    # GEMM around DotEngine on the model path
    assert sorted(raw) == [
        "ast-transcendental-scale::src/repro_torch/kernels/common.py::"
        "_stream_weights",
        "ast-transcendental-scale::src/repro_torch/kernels/tpmm/quantize.py"
        "::plane_reconstruct"]


def test_baseline_key_invalidated_by_move():
    a = ast_lint.baseline_key("ast-raw-dot", "src/a.py", "f")
    assert a != ast_lint.baseline_key("ast-raw-dot", "src/b.py", "f")
    assert a != ast_lint.baseline_key("ast-raw-dot", "src/a.py", "g")


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli():
    spec = importlib.util.spec_from_file_location(
        "olmlint_torch", ROOT / "tools" / "olmlint_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_cli_exits_zero_on_the_tree(cli, capsys):
    assert cli([]) == 0
    assert "olmlint: OK" in capsys.readouterr().out


def test_cli_exits_one_on_an_empty_baseline(cli, tmp_path):
    empty = tmp_path / "baseline.json"
    empty.write_text(json.dumps({"suppressions": []}))
    assert cli(["--engine", "ast", "--baseline", str(empty)]) == 1


def test_cli_exits_one_on_a_planted_serving_contraction(cli, tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "src" / "repro_torch" / "serving" / "sched.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(a, b):\n    return a @ b\n")
    monkeypatch.setattr(ast_lint, "_REPO_ROOT", str(tmp_path))
    assert cli(["--engine", "ast"]) == 1


def test_cli_exits_one_on_a_poisoned_tuning_cache(cli, tmp_path,
                                                  monkeypatch):
    path = tmp_path / "tuning_torch.json"
    path.write_text(json.dumps({"entries": {"bad": {
        "k_tile": 16, "block_m": 64, "block_n": 64, "tb": 1, "n_bits": 16,
        "shape": [64, 64, 64]}}}))
    monkeypatch.setattr(smem, "DEFAULT_CACHE_PATH", str(path))
    assert cli(["--engine", "kernels", "--widths", "16"]) == 1


def test_cli_write_baseline_round_trips(cli, tmp_path):
    path = tmp_path / "baseline.json"
    assert cli(["--engine", "ast", "--write-baseline",
                "--baseline", str(path)]) == 0
    assert set(json.loads(path.read_text())["suppressions"]) == \
        ast_lint.load_baseline()
    assert cli(["--engine", "ast", "--baseline", str(path)]) == 0


@pytest.mark.parametrize("argv", [["--widths", "12"], ["--widths", "x"],
                                  ["--engine", "jaxpr"]])
def test_cli_usage_errors_exit_two(cli, argv):
    with pytest.raises(SystemExit) as e:
        cli(argv)
    assert e.value.code == 2


def test_cli_sass_engine_fails_without_the_cards_build(cli, tmp_path,
                                                       monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    assert cli(["--engine", "sass"]) == 2


def test_violation_message_names_contract():
    vs = smem.check_launch("olm_matmul_fused", 16, _launch(threads=512),
                           where="fixture")
    msg = str(vs[0])
    assert "[launch-budget]" in msg and "contract:" in msg
