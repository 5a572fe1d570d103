"""The port's four examples (`examples/*_torch.py`) on the CPU against the
reference's originals: the quickstart's printed numbers equal, the numerics
twin's plain versions bit-identical and within the reference's figures,
the serve twin's integer counters (requests served, KV bytes resident in
each layout) equal to the reference's, and the train twin's loss going
down at smoke size. On the card chip_smoke.py's examples phase runs them
at their documented settings."""
import contextlib
import importlib.util
import io
import pathlib
import warnings

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = fn(*args)
    return buf.getvalue(), result


def test_quickstart_twin_prints_the_references_numbers():
    want, _ = _stdout(_example("quickstart").main)
    got, _ = _stdout(_example("quickstart_torch").main, [])
    assert got == want and "product = " in got


def test_numerics_twin_on_the_cpu():
    text, out = _stdout(_example("online_numerics_matmul_torch").main,
                        ["--device", "cpu"])
    assert out["device"] == "cpu" and out["olm_bitwise"]
    assert out["olm_bound_used"] <= 1.0
    # the plain tpmm gives the reference example's printed errors
    assert [f"{out['tpmm_rel'][nb]:.2e}" for nb in (8, 16, 24)] == \
        ["3.75e-02", "2.80e-04", "1.61e-06"]
    assert out["mlp_rel"] < 1e-2 and out["finite"]
    assert out["argmax_agree"] >= 0.9
    assert out["launches"] == {"olm_matmul_fused": 0, "tpmm": 0}
    assert "olm16" in text and "tpmm16" in text


def test_serve_twin_counters_equal_the_references():
    from repro.launch.serve import main as jserve
    _, (paged, contig) = _stdout(_example("serve_batched_torch").main,
                                 ["--device", "cpu"])
    common = ["--arch", "internlm2_1_8b", "--smoke", "--requests", "10",
              "--slots", "4", "--max-new", "12", "--max-len", "96"]
    _, jpaged = _stdout(jserve, common + ["--kv-layout", "paged",
                                          "--kv-block-size", "8"])
    _, jcontig = _stdout(jserve, common + ["--kv-layout", "contiguous"])
    assert paged["n"] == jpaged["n"] == 10
    assert paged["new_tokens"] == jpaged["new_tokens"]
    for got, want in ((paged, jpaged), (contig, jcontig)):
        assert got["kv"]["kv_layout"] == want["kv"]["kv_layout"]
        assert got["kv"]["kv_bytes_resident"] == \
            want["kv"]["kv_bytes_resident"]
        assert got["kv"]["kv_bytes_contiguous"] == \
            want["kv"]["kv_bytes_contiguous"]


def test_train_twin_improves_at_smoke_size():
    text, summary = _stdout(_example("train_lm_torch").main,
                            ["--smoke", "--steps", "8", "--lr", "3e-3",
                             "--device", "cpu"])
    assert summary["steps"] == 8 and summary["loss_improved"]
    assert summary["loss_last"] < summary["loss_first"]
    assert f"loss improved: {summary['loss_first']} ->" in text


def test_twins_refuse_to_drift_onto_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is real")
    with pytest.raises(RuntimeError, match="CUDA"):
        _stdout(_example("online_numerics_matmul_torch").main, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        _stdout(_example("serve_batched_torch").main, [])
