"""The port's mesh-sharded olm GEMM (`kernels/online_dot/matmul_sharded.py`)
against the reference's single-device `olm_matmul`, over 8 ranks of a
gloo group on the CPU.

One spawn of 8 ranks a module (the `sharded` fixture) runs every sharded
case on a ("model",) mesh of 8, and a ("data", "model") mesh of 2 x 4
for the collectives' shard/gather round trip; each rank saves its
outputs, and the tests read them. Meanwhile the test process computes
the reference's outputs from the same numpy inputs.

The contract, the reference's (tests/test_distributed_matmul.py): the
27 rows of results/baseline/BENCH_olm_matmul_distributed.json (every
registered olm mode x m/n/k at size 64) with their byte columns exactly,
m and n bit-identical to the single-device `olm_matmul`, k within
`olm_error_bound`; TestShardedSweep, TestEngineDispatch and
TestPartitionSpecs mirrored at size 32; and every rank returning the
same whole output.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.online_dot.matmul import olm_error_bound as jax_bound
from repro.kernels.online_dot.matmul import olm_matmul as jax_olm_matmul
from repro_torch.core.numerics import DotEngine
from repro_torch.kernels.online_dot.matmul import olm_matmul
from repro_torch.kernels.online_dot.matmul_sharded import (
    gemm_partition_specs, local_shapes, sharded_traffic)
from torch_rank_cases import (ALL_CASES, PARTS, ROW_SIZE, free_port, label,
                              lead_operands, matmul_rank, row_operands,
                              sweep_operands)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8


def _reference():
    """The reference's single-device outputs, bounds and exact products."""
    ref = {}
    for tag, (x, w) in (("row", row_operands()),
                        ("sweep", sweep_operands())):
        for n, p in ALL_CASES:
            ref[f"{tag}/{label(n, p)}"] = (
                np.asarray(jax_olm_matmul(x, w, n_bits=n, trunc=p)),
                np.asarray(jax_bound(x, w, n_bits=n, trunc=p)),
                x.astype(np.float64) @ w.astype(np.float64))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference by case, rank -> {"out", "errors"}): one 8-rank
    spawn, the reference computed while the ranks run."""
    import torch.multiprocessing as mp
    out_dir = str(tmp_path_factory.mktemp("sharded"))
    ctx = mp.start_processes(matmul_rank, args=(RANKS, free_port(), out_dir),
                             nprocs=RANKS, join=False, start_method="spawn")
    try:
        ref = _reference()
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return ref, [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
                 for r in range(RANKS)]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[1]


def _out(sharded, key):
    return sharded[0]["out"][key].numpy()


def test_every_rank_returns_the_whole_output(sharded):
    keys = sharded[0]["out"].keys()
    assert len(keys) > 2 * 27
    for r in range(1, RANKS):
        assert sharded[r]["out"].keys() == keys
        assert all(torch.equal(sharded[r]["out"][k], sharded[0]["out"][k])
                   for k in keys), f"rank {r}"


BASELINE = {r["op"]: r for r in json.loads(
    (ROOT / "results/baseline/BENCH_olm_matmul_distributed.json")
    .read_text())["rows"]}


@pytest.mark.parametrize("n,p", ALL_CASES,
                         ids=[label(n, p) for n, p in ALL_CASES])
@pytest.mark.parametrize("part", PARTS)
def test_baseline_row(sharded, reference, n, p, part):
    row = BASELINE[f"olm_matmul_distributed/{label(n, p)}/{part}"]
    assert (row["n"], row["k"]) == (n, ROW_SIZE)
    tr = sharded_traffic(ROW_SIZE, ROW_SIZE, ROW_SIZE, partition=part,
                         devices=RANKS, n_bits=n, trunc=p)
    assert tr["local"]["fused_bytes"] == row["bytes_moved"]
    assert tr["collective_bytes"] == row["bytes_float"]
    got = _out(sharded, f"row/{label(n, p)}/{part}")
    ref, bound, exact = reference[f"row/{label(n, p)}"]
    if part in ("m", "n"):
        np.testing.assert_array_equal(got, ref)
        assert row["ulp"] == 0.0
    else:
        assert (np.abs(got - exact) <= bound).all()


class TestShardedSweep:
    @pytest.mark.parametrize("n,p", ALL_CASES,
                             ids=[label(n, p) for n, p in ALL_CASES])
    @pytest.mark.parametrize("part", ["m", "n"])
    def test_output_sharded_bit_identical(self, sharded, reference, n, p,
                                          part):
        np.testing.assert_array_equal(
            _out(sharded, f"sweep/{label(n, p)}/{part}"),
            reference[f"sweep/{label(n, p)}"][0])

    @pytest.mark.parametrize("n,p", ALL_CASES,
                             ids=[label(n, p) for n, p in ALL_CASES])
    def test_k_sharded_within_bound(self, sharded, reference, n, p):
        _, bound, exact = reference[f"sweep/{label(n, p)}"]
        got = _out(sharded, f"sweep/{label(n, p)}/k")
        assert (np.abs(got - exact) <= bound).all()

    def test_k_sharded_not_assumed_identical(self, sharded, reference):
        # the k path is only bound-accurate: the sum over ranks is in
        # another order than the single-device walk over K tiles
        assert not np.array_equal(_out(sharded, "sweep/olm16/k"),
                                  reference["sweep/olm16"][0])

    def test_auto_tiling_bit_identical(self, sharded):
        for part in ("m", "n"):
            np.testing.assert_array_equal(_out(sharded, f"auto/{part}"),
                                          _out(sharded, f"sweep/olm16/{part}"))

    def test_divisibility_error(self, sharded):
        assert "divisible by the mesh axis" in sharded[0]["errors"][
            "divisibility"]

    def test_unknown_axis_error(self, sharded):
        assert "mesh has no axis" in sharded[0]["errors"]["unknown_axis"]


class TestEngineDispatch:
    def _single(self, x, w):
        return DotEngine(mode="olm16").dot(torch.from_numpy(x),
                                           torch.from_numpy(w)).numpy()

    @pytest.mark.parametrize("part", ["m", "n"])
    def test_engine_sharded_matches_single_device(self, sharded, part):
        np.testing.assert_array_equal(_out(sharded, f"engine/{part}"),
                                      self._single(*sweep_operands()))

    def test_engine_k_sharded_within_bound(self, sharded, reference):
        _, bound, exact = reference["sweep/olm32t16"]
        got = _out(sharded, "engine/k/olm32t16")
        assert (np.abs(got - exact) <= bound).all()

    def test_engine_3d_lead_axes(self, sharded):
        got = _out(sharded, "engine/lead3d")
        assert got.shape == (4, 8, 32)
        np.testing.assert_array_equal(got, self._single(*lead_operands()))

    def test_engine_auto_tiling_sharded(self, sharded):
        np.testing.assert_array_equal(_out(sharded, "engine/auto/n"),
                                      _out(sharded, "engine/n"))

    def test_mesh_without_shard_stays_single_device(self, sharded):
        np.testing.assert_array_equal(_out(sharded, "engine/inert"),
                                      self._single(*sweep_operands()))


@pytest.mark.parametrize("name", ["both", "split", "model"])
def test_collectives_shard_and_gather_as_dtensor(sharded, name):
    for r in range(RANKS):
        for what in ("chunk", "gather", "dtensor"):
            assert bool(sharded[r]["out"][f"coll/{name}/{what}"]), \
                (r, what)


class TestPartitionSpecs:
    def test_specs_and_local_shapes(self):
        (xs, ws), out = gemm_partition_specs("m", "model")
        assert (xs, ws, out) == (("model", None), (None, None),
                                 ("model", None))
        (xs, ws), out = gemm_partition_specs("k", "model")
        assert (xs, ws, out) == ((None, "model"), ("model", None),
                                 (None, None))
        assert local_shapes(64, 32, 16, "m", 8) == (8, 32, 16)
        assert local_shapes(64, 32, 16, "n", 8) == (64, 4, 16)
        assert local_shapes(64, 32, 16, "k", 8) == (64, 32, 2)
        with pytest.raises(ValueError, match="unknown GEMM partition"):
            gemm_partition_specs("q")

    def test_specs_are_the_references(self):
        from repro.kernels.online_dot.matmul_sharded import (
            gemm_partition_specs as jax_specs)
        from repro.kernels.online_dot.matmul_sharded import (
            local_shapes as jax_local)
        for part in PARTS:
            (jx, jw), jo = jax_specs(part, "model")
            assert gemm_partition_specs(part, "model") == (
                (tuple(jx), tuple(jw)), tuple(jo))
            assert local_shapes(64, 32, 16, part, 8) == jax_local(
                64, 32, 16, part, 8)
        for args in ((12, 16, 16, "m", 8), (8, 8, 8, "q", 2)):
            with pytest.raises(ValueError) as ours:
                local_shapes(*args)
            with pytest.raises(ValueError) as theirs:
                jax_local(*args)
            assert str(ours.value) == str(theirs.value)

    def test_sharder_reexport(self):
        from repro_torch.distributed.sharding import \
            gemm_partition_specs as from_sharding
        assert from_sharding("n", "model") == gemm_partition_specs(
            "n", "model")

    def test_traffic_ledger(self):
        from repro.kernels.online_dot.matmul_sharded import (
            sharded_traffic as jax_traffic)
        mn = sharded_traffic(64, 64, 64, partition="m", devices=8, n_bits=16)
        k = sharded_traffic(64, 64, 64, partition="k", devices=8, n_bits=16)
        assert mn["collective_bytes"] == 0
        # ring reduce-scatter + all-gather of the (M, N) f32 output
        assert k["collective_bytes"] == 8 * 64 * 64 * 7
        assert k["local"]["fused_bytes"] < \
            sharded_traffic(64, 64, 64, partition="k", devices=2,
                            n_bits=16)["local"]["fused_bytes"]
        for part in PARTS:
            for kw in (dict(n_bits=16), dict(n_bits=32, trunc=16)):
                assert sharded_traffic(48, 64, 32, partition=part,
                                       devices=4, **kw) == jax_traffic(
                    48, 64, 32, partition=part, devices=4, **kw)

    def test_port_single_device_is_the_references(self):
        # the single-device GEMM the sharded blocks are held against
        x, w = sweep_operands()
        np.testing.assert_array_equal(
            olm_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
            np.asarray(jax_olm_matmul(x, w, n_bits=16)))
