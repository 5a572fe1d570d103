"""The port's fault injection and traffic replay against the reference and
its committed baselines.

(a) `build_fault_plan` and `build_workload` give the reference's plans
    and schedules (numpy-seeded copies of its generators).
(b) The seed-0 faulted replay of `benchmarks/run.py::serve_faults_bench`
    with the olm16 ladder (olm16, olm16t12, olm16t10) that chip_smoke.py
    drives at full width: the port engine matches the reference engine
    request for request, counters and `identical_to_ref` included
    (bridged weights, f32 compute, where the olm modes are
    bit-identical). It runs at the tiny width of
    tests/test_serving_robustness.py: the step counts do not depend on
    the width, and at the smoke width the two replays take minutes.
(d) The replay bench's workload reproduces all 11 rows of
    results/baseline/BENCH_serve_replay.json (floats to the JSON's
    rounding), and the paged and contiguous token streams are identical.

Step counts depend only on the workload and the scheduler (eos_id=None),
so they must match at any width and on any device. The bench's own
configuration, row for row against the baseline, is in
tests/test_torch_serving_fault_rows.py.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.numerics import DotEngine as JEngine
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.serving import faults as jfaults
from repro.serving import replay as jreplay
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving import (FaultConfig, FaultInjector, ReplayConfig,
                                 ServeEngine, build_fault_plan,
                                 build_workload, run_replay)

ARCH = "internlm2_1_8b"
BASELINE = Path(__file__).resolve().parents[1] / "results" / "baseline"
KNOWN = {"eos", "length", "max_len", "cache_full", "deadline", "rejected",
         "numerics", "failed"}
OLM16_LADDER = ["olm16", "olm16t12", "olm16t10"]
TINY = dict(name="t", family="dense", n_layers=2, d_model=16, n_heads=2,
            n_kv_heads=2, d_ff=32, vocab_size=512, param_dtype="float32",
            compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(name):
    rows = json.loads((BASELINE / f"BENCH_{name}.json").read_text())["rows"]
    return {r["op"]: r for r in rows}


# --- (a) seeded plans and workloads -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_plan_and_workload_equal_the_reference(seed):
    kw = dict(seed=seed, horizon_steps=20 + 7 * seed, exhaust_blocks=16,
              exhaust_hold_steps=6, n_corrupt=1 + seed % 2)
    assert build_fault_plan(FaultConfig(**kw)) == \
        jfaults.build_fault_plan(jfaults.FaultConfig(**kw))
    rk = dict(seed=seed, n_requests=20, prompt_len_range=(4, 16),
              deadline_every=6, deadline_steps=30, priority_levels=2)
    ours = build_workload(ReplayConfig(**rk))
    theirs = jreplay.build_workload(jreplay.ReplayConfig(**rk))
    assert [{k: v for k, v in w.items() if k != "prompt"} for w in ours] == \
        [{k: v for k, v in w.items() if k != "prompt"} for w in theirs]
    for a, b in zip(ours, theirs):
        assert a["prompt"].dtype == b["prompt"].dtype
        np.testing.assert_array_equal(a["prompt"], b["prompt"])


# --- the bench's drive, for either package ------------------------------------

def _bench_engine(engine_cls, model, params, ladder, **extra):
    return engine_cls(model, params, slots=4, max_len=64, kv_layout="paged",
                      kv_block_size=8, kv_blocks=21, max_queue=8,
                      preempt=True, numerics_check=True,
                      integrity_audit=True, degrade_ladder=ladder, **extra)


def faults_replay(make_engine, rp, seed, vocab):
    """serve_faults_bench's drive of one seed: the fault-free run, the
    faulted run, its invariants, and its rows (identical_to_ref last)."""
    rc = rp.ReplayConfig(seed=seed, n_requests=20,
                         mean_interarrival_steps=2.0,
                         prompt_len_range=(4, 16), max_new_range=(4, 10),
                         vocab=vocab, deadline_every=6, deadline_steps=30,
                         priority_levels=2)
    workload = rp.build_workload(rc)
    ref_done, ref_rep = rp.run_replay(make_engine(), workload)
    ref = {r.rid: (tuple(r.output), r.finish_reason) for r in ref_done}
    fc = rp.FaultConfig(seed=seed,
                        horizon_steps=max(10, int(ref_rep["steps_total"])
                                          * 2 // 3),
                        exhaust_blocks=16, exhaust_hold_steps=6)
    eng = make_engine()
    inj = rp.FaultInjector(rp.build_fault_plan(fc))
    done, rep = rp.run_replay(eng, workload, faults=inj)
    stats, ctr = inj.summary(), eng.counters
    for fam in ("exhaust", "corrupt", "nan", "prefill_fail"):
        assert stats.get(fam, 0) >= 1, f"fault family {fam!r} never fired"
    assert len(done) == rc.n_requests
    assert all(r.finish_reason in KNOWN for r in done)
    assert rep["n_numerics"] == stats["nan"]
    assert ctr["table_repairs"] == stats["corrupt"]
    assert ctr["prefill_retries"] == stats["prefill_fail"]
    assert ctr["preempted"] >= 1
    identical = 0
    for r in done:
        out, reason = tuple(r.output), r.finish_reason
        if (out, reason) == ref[r.rid]:
            identical += 1
            continue
        assert (r.n_preempts or r.n_retries or r.degrade_rung
                or reason in ("numerics", "deadline", "rejected",
                              "cache_full", "failed")), \
            f"rid {r.rid} diverged with no recorded fault or recovery"
        if r.n_preempts and not r.degrade_rung and reason == ref[r.rid][1]:
            assert out == ref[r.rid][0]
        if reason == "deadline" and not r.degrade_rung:
            assert out == ref[r.rid][0][:len(out)]
    kvr = eng.kv_report()
    assert kvr["integrity_ok"] and kvr["kv_blocks_held"] == 0
    pre = f"serve_faults/s{seed}/"
    rows = {
        pre + "completed": rep["n"],
        pre + "steps_total": rep["steps_total"],
        pre + "injected_exhaust": stats.get("exhaust", 0),
        pre + "injected_corrupt": stats.get("corrupt", 0),
        pre + "injected_nan": stats.get("nan", 0),
        pre + "injected_prefill_fail": stats.get("prefill_fail", 0),
        pre + "preempted": int(ctr["preempted"]),
        pre + "table_repairs": int(ctr["table_repairs"]),
        pre + "prefill_retries": int(ctr["prefill_retries"]),
        pre + "degraded": int(ctr["degraded"]),
        pre + "n_deadline": rep["n_deadline"],
        pre + "n_rejected": rep["n_rejected"],
        pre + "n_numerics": rep["n_numerics"],
        pre + "n_cache_full": rep["n_cache_full"],
        pre + "identical_to_ref": identical,
    }
    key = {r.rid: (tuple(r.output), r.finish_reason, r.n_preempts,
                   r.n_retries, r.degrade_rung, r.served_tier, r.s_done)
           for r in done}
    return rows, key, dict(ctr), stats


class _Port:
    """The port's replay surface under the names faults_replay uses."""
    ReplayConfig, build_workload, run_replay = (ReplayConfig, build_workload,
                                                run_replay)
    FaultConfig, FaultInjector, build_fault_plan = (FaultConfig,
                                                    FaultInjector,
                                                    build_fault_plan)


class _Ref:
    ReplayConfig, build_workload, run_replay = (jreplay.ReplayConfig,
                                                jreplay.build_workload,
                                                jreplay.run_replay)
    FaultConfig, FaultInjector, build_fault_plan = (
        jfaults.FaultConfig, jfaults.FaultInjector, jfaults.build_fault_plan)


# --- (b) the olm16 ladder against the reference engine ------------------------

@pytest.fixture(scope="module")
def _compile_cache(tmp_path_factory):
    # The reference engine compiles its entry points anew for each engine:
    # with the persistent cache the fault-free and the faulted engine
    # compile the same programs once.
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    jax.config.update(keys[0], str(tmp_path_factory.mktemp("jax_cache")))
    jax.config.update(keys[1], 0)
    jax.config.update(keys[2], 0)
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_olm16_faulted_replay_matches_the_reference_engine(_compile_cache):
    jcfg, cfg = JConfig(**TINY), ModelConfig(**TINY)
    jm = JModel(jcfg, JEngine(mode="olm16", use_pallas=False))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, DotEngine(mode="olm16"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    want = faults_replay(lambda: _bench_engine(JServeEngine, jm, jp,
                                               OLM16_LADDER),
                         _Ref, 0, cfg.vocab_size)
    got = faults_replay(lambda: _bench_engine(ServeEngine, tm, tp,
                                              OLM16_LADDER, device="cpu"),
                        _Port, 0, cfg.vocab_size)
    assert got == want
    # the step-counted rows equal the committed baseline's (its ladder is
    # another one; these rows do not depend on the modes)
    base = _rows("serve_faults")
    for op, v in got[0].items():
        if not op.endswith("identical_to_ref"):
            assert v == base[op]["derived"], op


@pytest.fixture(scope="module")
def bench_model():
    cfg = smoke_config(ARCH)
    model = Model(cfg, device="cpu")
    return model, model.init(seed=0)


# --- (d) the replay bench ------------------------------------------------------

def test_replay_bench_reproduces_the_baseline(bench_model):
    model, params = bench_model
    rc = ReplayConfig(seed=0, n_requests=24, mean_interarrival_steps=2.0,
                      prompt_len_range=(4, 24), max_new_range=(4, 10),
                      vocab=model.cfg.vocab_size)
    workload = build_workload(rc)
    engines, reports, outputs = {}, {}, {}
    for label, kw in (("paged", dict(kv_layout="paged", kv_block_size=8,
                                     kv_blocks=21)),
                      ("contig", dict(kv_layout="contiguous"))):
        eng = ServeEngine(model, params, slots=4, max_len=64,
                          dot_tiling="auto", device="cpu", **kw)
        done, rep = run_replay(eng, workload)
        engines[label], reports[label] = eng, rep
        outputs[label] = {r.rid: tuple(r.output) for r in done}
    assert outputs["paged"] == outputs["contig"]
    kvp, kvc = engines["paged"].kv_report(), engines["contig"].kv_report()
    rep = reports["paged"]
    ratio = kvp["kv_bytes_resident"] / kvc["kv_bytes_resident"]
    got = {
        "serve_replay/ttft_p50": (rep["ttft_steps_p50"], {}),
        "serve_replay/ttft_p99": (rep["ttft_steps_p99"], {}),
        "serve_replay/e2e_p50": (rep["e2e_steps_p50"], {}),
        "serve_replay/e2e_p99": (rep["e2e_steps_p99"], {}),
        "serve_replay/tokens_per_step": (rep["tokens_per_step"], {}),
        "serve_replay/completed": (rep["n"], {}),
        "serve_replay/cache_full": (rep["n_cache_full"], {}),
        "serve_replay/prefill_compiles": (engines["paged"].prefill_traces,
                                          {}),
        "serve_replay/blocks_peak": (kvp["kv_blocks_peak_used"], {}),
        "serve_replay/kv_paged": (round(ratio, 4), {
            "bytes_moved": kvp["kv_bytes_resident"],
            "bytes_float": kvp["kv_bytes_contiguous"]}),
        "serve_replay/kv_contig": (None, {
            "bytes_moved": kvc["kv_bytes_resident"]}),
    }
    base = _rows("serve_replay")
    assert set(got) == set(base)
    for op, (derived, extra) in got.items():
        assert derived == base[op]["derived"], op
        for k, v in extra.items():
            assert v == base[op][k], (op, k)
    assert (engines["paged"].prefill_traces, kvp["kv_blocks_peak_used"],
            kvp["kv_bytes_resident"], kvc["kv_bytes_resident"]) == \
        (5, 14, 86016, 131072)
