"""The serve_faults bench's own configuration through the port, row for
row against results/baseline/BENCH_serve_faults.json: the smoke config,
its default mode and ladder [native, olm32t24, olm32t16], seeds 0 and 1
(the drive is test_torch_serving_faults.faults_replay, a copy of
`benchmarks/run.py::serve_faults_bench`'s).

Every row is reproduced exactly except the two `identical_to_ref` rows:
those count tokens equal across a faulted and a fault-free run, which
under native bf16 arithmetic depend on each package's own rounding. They
are held to the bench's invariant instead (every divergence has a
recorded fault or recovery), which faults_replay asserts.

Each seed's replay runs once, in a module-scoped fixture, for all of its
rows; each row is its own test case.
"""
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models.model import Model
from repro_torch.serving import ServeEngine
from test_torch_serving_faults import (ARCH, _bench_engine, _Port, _rows,
                                       faults_replay)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_model():
    cfg = smoke_config(ARCH)
    model = Model(cfg, device="cpu")
    return model, model.init(seed=0)


ROWS = ("completed", "steps_total", "injected_exhaust", "injected_corrupt",
        "injected_nan", "injected_prefill_fail", "preempted",
        "table_repairs", "prefill_retries", "degraded", "n_deadline",
        "n_rejected", "n_numerics", "n_cache_full")


@pytest.fixture(scope="module", params=[0, 1])
def bench_rows(request, bench_model):
    """One seed's replay under the bench's engine, run once for all of its
    rows (faults_replay asserts the bench's invariants on the way)."""
    model, params = bench_model
    ladder = [model.eng.mode, "olm32t24", "olm32t16"]
    rows, _, _, _ = faults_replay(
        lambda: _bench_engine(ServeEngine, model, params, ladder,
                              device="cpu"), _Port, request.param,
        model.cfg.vocab_size)
    return request.param, rows


def _baseline(seed):
    pre = f"serve_faults/s{seed}/"
    return {op[len(pre):]: r["derived"]
            for op, r in _rows("serve_faults").items() if op.startswith(pre)}


def test_bench_replay_reports_the_baselines_rows(bench_rows):
    # the same rows as the baseline: the step-counted ones, held one by
    # one below, and identical_to_ref, held to the bench's invariant
    seed, rows = bench_rows
    pre = f"serve_faults/s{seed}/"
    assert {op[len(pre):] for op in rows} == set(_baseline(seed)) \
        == set(ROWS) | {"identical_to_ref"}


@pytest.mark.parametrize("row", ROWS)
def test_bench_row_reproduces_the_baseline(bench_rows, row):
    seed, rows = bench_rows
    assert rows[f"serve_faults/s{seed}/{row}"] == _baseline(seed)[row]
