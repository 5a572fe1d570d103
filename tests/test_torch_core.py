"""The port's copy of the paper's backend-neutral core against the JAX
package's, exactly: the SD codec, the online adder, the online multiplier
(digits and traces), the unrolled pipeline (Table III's cycles), the
online inner product (pipelined and not), and the gate-level cost model
(Tables I and II). Both are plain Python and numpy, so every output must
be equal, not close.

Then the port's scalar model as the oracle of its own batched plain
versions, the ones its CUDA kernels K3 and K4 are held against bit for
bit: `online_mul_batch_ref` against `online_multiply` and
`online_dot_batch_ref` against `inner_product.online_dot`, digit for
digit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hwmodel as jhw
from repro.core import inner_product as jip
from repro.core import online_add as jadd
from repro.core import online_mul as jmul
from repro.core import pipeline as jpipe
from repro.core import sd as jsd
from repro.core.precision import OnlinePrecision as JPrecision
from repro_torch.core import hwmodel as thw
from repro_torch.core import inner_product as tip
from repro_torch.core import online_add as tadd
from repro_torch.core import online_mul as tmul
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sd as tsd
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot.ref import online_dot_batch_ref
from repro_torch.kernels.online_mul.ref import online_mul_batch_ref

WIDTHS = (8, 16, 24, 32)
PRECISIONS = ([dict(n=n) for n in WIDTHS]
              + [dict(n=n, truncated=False, tail_gating=False)
                 for n in (8, 16, 24)]
              + [dict(n=16, delta=4), dict(n=16, t=3), dict(n=12,
                                                             tail_guard=1),
                 dict(n=8, tail_gating=False)])


def cfgs(kw):
    return JPrecision(**kw), OnlinePrecision(**kw)


def rand_digits(rng, n):
    return [int(d) for d in rng.integers(-1, 2, size=n)]


def fields(obj):
    """A result as plain data, classes aside."""
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


# --- the SD codec -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 8, 16])
def test_sd_codec_matches_reference(n):
    rng = np.random.default_rng(n)
    values = [0, 1, -1, 2 ** n - 1, -(2 ** n - 1)] + [
        int(v) for v in rng.integers(-(2 ** n) + 1, 2 ** n, 20)]
    for v in values:
        d = tsd.int_to_digits(v, n)
        assert d == jsd.int_to_digits(v, n)
        assert tsd.digits_to_int(d) == jsd.digits_to_int(d) == v
        assert tsd.digits_to_frac(d) == jsd.digits_to_frac(d)
        assert tsd.digits_to_nonredundant(d) == jsd.digits_to_nonredundant(d)
    for x in rng.uniform(-1, 1, 20):
        assert tsd.frac_to_digits(float(x), n) == jsd.frac_to_digits(float(x), n)
    for _ in range(20):
        d = rand_digits(rng, n)
        assert tsd.digits_to_int(d) == jsd.digits_to_int(d)
        assert tsd.OTFC.convert(d) == jsd.OTFC.convert(d) \
            == tsd.digits_to_int(d)
    a = tsd.random_digits(np.random.default_rng(3), n, batch=4)
    b = jsd.random_digits(np.random.default_rng(3), n, batch=4)
    assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        tsd.int_to_digits(2 ** n, n)
    with pytest.raises(ValueError):
        tsd.OTFC().append(2)


# --- the online adder ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 8, 16, 34])
def test_online_add_matches_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(30):
        x, y = rand_digits(rng, n), rand_digits(rng, n)
        out = tadd.online_add(x, y)
        assert out == jadd.online_add(x, y)
        assert tsd.digits_to_int(out, n + 2) == 2 * (
            tsd.digits_to_int(x, n) + tsd.digits_to_int(y, n))
    ta, ja = tadd.OnlineAdder(), jadd.OnlineAdder()
    x, y = rand_digits(rng, n), rand_digits(rng, n)
    assert ([ta.push(a, b) for a, b in zip(x, y)] + ta.flush()
            == [ja.push(a, b) for a, b in zip(x, y)] + ja.flush())
    assert tadd.DELTA_ADD == jadd.DELTA_ADD == 2


# --- the online multiplier ----------------------------------------------------

def test_selm_and_working_precision_match_reference():
    assert [tmul.selm(v) for v in range(-12, 13)] == \
        [jmul.selm(v) for v in range(-12, 13)]
    for kw in PRECISIONS:
        jc, tc = cfgs(kw)
        js = [jmul.working_precision(jc, j) for j in range(-jc.delta, jc.n)]
        assert [tmul.working_precision(tc, j)
                for j in range(-tc.delta, tc.n)] == js
        assert (tc.p, tc.steps, tc.pipeline_latency, tc.stream_cycles(7)) \
            == (jc.p, jc.steps, jc.pipeline_latency, jc.stream_cycles(7))


@pytest.mark.parametrize("kw", PRECISIONS, ids=str)
def test_online_multiply_digits_and_trace_match_reference(kw):
    jc, tc = cfgs(kw)
    rng = np.random.default_rng(tc.n + tc.delta + tc.t)
    for _ in range(12):
        x, y = rand_digits(rng, tc.n), rand_digits(rng, tc.n)
        want = jmul.online_multiply(x, y, jc)
        got = tmul.online_multiply(x, y, tc)
        assert fields(got) == fields(want)
        assert (got.n, got.z_value) == (want.n, want.z_value)


def test_online_mul_state_steps_match_reference():
    jc, tc = cfgs(dict(n=16))
    rng = np.random.default_rng(5)
    x, y = rand_digits(rng, 16), rand_digits(rng, 16)
    js, ts = jmul.OnlineMulState(jc), tmul.OnlineMulState(tc)
    while not ts.done:
        assert ts.step(x, y) == js.step(x, y)
        assert (ts.X, ts.Y, ts.W, ts.Z, ts.j, ts.flips) == \
            (js.X, js.Y, js.W, js.Z, js.j, js.flips)
    assert js.done
    with pytest.raises(ValueError):
        tmul.online_multiply(x, y[:-1])


# --- the pipeline and the inner product ---------------------------------------

@pytest.mark.parametrize("n,k", [(8, 1), (8, 5), (16, 9), (24, 4), (32, 3)])
def test_run_pipeline_matches_reference(n, k):
    jc, tc = cfgs(dict(n=n))
    rng = np.random.default_rng(n * k)
    pairs = [(rand_digits(rng, n), rand_digits(rng, n)) for _ in range(k)]
    want, got = jpipe.run_pipeline(pairs, jc), tpipe.run_pipeline(pairs, tc)
    assert fields(got) == fields(want)
    assert (got.peak_active, got.utilization) == \
        (want.peak_active, want.utilization)
    # Table III: (n + delta + 1) + (k - 1) cycles to drain the stream
    assert got.cycles == n + tc.delta + k
    assert tpipe.stage_slice_schedule(tc) == jpipe.stage_slice_schedule(jc)
    for t, (x, y) in zip(got.traces, pairs):
        assert t.z_digits == tmul.online_multiply(x, y, tc).z_digits


@pytest.mark.parametrize("kw", [dict(n=8), dict(n=16),
                                dict(n=10, truncated=False,
                                     tail_gating=False)], ids=str)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13])
def test_online_dot_matches_reference(kw, k):
    jc, tc = cfgs(kw)
    rng = np.random.default_rng(k)
    xs = [rand_digits(rng, tc.n) for _ in range(k)]
    ys = [rand_digits(rng, tc.n) for _ in range(k)]
    for jf, tf in ((jip.online_dot, tip.online_dot),
                   (jip.online_dot_pipelined, tip.online_dot_pipelined)):
        want, got = jf(xs, ys, jc), tf(xs, ys, tc)
        assert fields(got) == fields(want)
        assert got.dot_value == want.dot_value
    with pytest.raises(ValueError):
        tip.online_dot([], [], tc)


# --- the cost model (Tables I and II) -----------------------------------------

@pytest.mark.parametrize("n", WIDTHS)
def test_hwmodel_costs_match_reference(n):
    for truncated in (True, False):
        kw = dict(n=n, truncated=truncated, tail_gating=truncated)
        jc, tc = cfgs(kw)
        for activity in (1.0, 0.63):
            want = jhw.online_multiplier_cost(jc, activity=activity)
            got = thw.online_multiplier_cost(tc, activity=activity)
            assert fields(got) == fields(want)
            assert got.row() == want.row()
    for jf, tf in ((jhw.nonpipelined_online_cost, thw.nonpipelined_online_cost),
                   (jhw.serial_parallel_cost, thw.serial_parallel_cost),
                   (jhw.array_multiplier_cost, thw.array_multiplier_cost)):
        assert fields(tf(n)) == fields(jf(n))
    for p in range(4, n):
        assert thw.truncated_delta(n, p) == jhw.truncated_delta(n, p)


def test_paper_tables_and_constants_match_reference():
    assert thw.PAPER_TABLE1 == jhw.PAPER_TABLE1
    assert thw.PAPER_TABLE2 == jhw.PAPER_TABLE2
    assert thw.GATE_AREA == jhw.GATE_AREA
    assert (thw.LATCH_AREA, thw.FA_AREA, thw.COMP42_AREA, thw.MUX2_AREA,
            thw.SELECTOR_AREA, thw.POWER_PER_AREA_ACTIVITY) == \
        (jhw.LATCH_AREA, jhw.FA_AREA, jhw.COMP42_AREA, jhw.MUX2_AREA,
         jhw.SELECTOR_AREA, jhw.POWER_PER_AREA_ACTIVITY)
    # the savings the abstract quotes come out of the same schedule
    for n in WIDTHS:
        full = thw.online_multiplier_cost(
            OnlinePrecision(n=n, truncated=False, tail_gating=False))
        red = thw.online_multiplier_cost(OnlinePrecision(n=n))
        assert red.area < full.area and red.latches < full.latches


# --- the scalar model as the oracle of the batched plain versions ------------

@pytest.mark.parametrize("kw", [dict(n=8), dict(n=16), dict(n=32),
                                dict(n=16, truncated=False,
                                     tail_gating=False)], ids=str)
def test_batched_online_mul_equals_the_scalar_model(kw):
    cfg = OnlinePrecision(**kw)
    rng = np.random.default_rng(cfg.n)
    x = rng.integers(-1, 2, (32, cfg.n)).astype(np.int32)
    y = rng.integers(-1, 2, (32, cfg.n)).astype(np.int32)
    z, _ = online_mul_batch_ref(torch.from_numpy(x), torch.from_numpy(y),
                                n=cfg.n, truncated=cfg.truncated,
                                tail_gating=cfg.tail_gating)
    for b in range(32):
        want = tmul.online_multiply([int(v) for v in x[b]],
                                    [int(v) for v in y[b]], cfg).z_digits
        assert z[b].tolist() == want


@pytest.mark.parametrize("k,n", [(1, 8), (3, 8), (8, 16), (13, 16), (4, 32)])
def test_batched_online_dot_equals_the_scalar_model(k, n):
    cfg = OnlinePrecision(n=n)
    rng = np.random.default_rng(k + n)
    x = rng.integers(-1, 2, (6, k, n)).astype(np.int32)
    y = rng.integers(-1, 2, (6, k, n)).astype(np.int32)
    z = online_dot_batch_ref(torch.from_numpy(x), torch.from_numpy(y), n=n)
    for b in range(6):
        want = tip.online_dot([[int(v) for v in row] for row in x[b]],
                              [[int(v) for v in row] for row in y[b]], cfg)
        assert z[b].tolist() == want.digits
