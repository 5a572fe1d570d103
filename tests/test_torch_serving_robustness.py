"""The port's fault-tolerant ServeEngine against the reference engine, one
case per behaviour of tests/test_serving_robustness.py (deadlines,
backpressure, preemption, the admission deadlock guard, the degrade
ladder, the integrity guards, the numerics guard, the finish-reason
lattice) and tests/test_serving_engine.py::TestChunkedPrefill.

Each case drives the same scenario through both packages: the same tiny
dense model on bridged weights (`convert.params_from_jax`) under
dot_mode="olm16" with f32 compute, where the two are bit-identical. Per
request it compares (output, finish_reason, n_preempts, n_retries,
degrade_rung, served_tier, s_done) exactly, and the engines' counters;
scenarios that check a refusal compare the error raised. The scenario
also asserts the reference test's own claims on both.

The reference engine compiles its entry points anew for every engine, so
the module turns on JAX's persistent compilation cache in a temporary
directory: the scenarios' identical programs compile once.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.numerics import DotEngine as JEngine
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.serving.degrade import DegradeLadder as JLadder
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.degrade import DegradeLadder
from repro_torch.serving.engine import Request, ServeEngine

VOCAB = 512
BASE = "olm16"
CFG = dict(name="t", family="dense", n_layers=2, d_model=16, n_heads=2,
           n_kv_heads=2, d_ff=32, vocab_size=VOCAB, param_dtype="float32",
           compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def _compile_cache(tmp_path_factory):
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


class Kit:
    """One package's serving surface for a scenario."""

    def __init__(self, name, request, engine, ladder, model, params):
        self.name, self.Request, self._engine = name, request, engine
        self.Ladder, self._model, self.params = ladder, model, params

    def model(self, mode=BASE):
        return self._model(mode)

    def engine(self, mode=BASE, **kw):
        if self.name == "torch":
            kw["device"] = "cpu"
        return self._engine(self.model(mode), self.params, **kw)


@pytest.fixture(scope="module")
def kits(_compile_cache):
    jcfg, cfg = JConfig(**CFG), ModelConfig(**CFG)
    jp = JModel(jcfg, JEngine()).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jmodels, tmodels = {}, {}

    def jmodel(mode):
        if mode not in jmodels:
            jmodels[mode] = JModel(jcfg, JEngine(mode=mode, use_pallas=False))
        return jmodels[mode]

    def tmodel(mode):
        if mode not in tmodels:
            tmodels[mode] = Model(cfg, DotEngine(mode=mode), device="cpu")
        return tmodels[mode]

    return (Kit("jax", JRequest, JServeEngine, JLadder, jmodel, jp),
            Kit("torch", Request, ServeEngine, DegradeLadder, tmodel, tp))


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lens]


def _key(done):
    return [(r.rid, list(r.output), r.finish_reason, r.n_preempts,
             r.n_retries, r.degrade_rung, r.served_tier, r.s_done)
            for r in sorted(done, key=lambda r: r.rid)]


def _serve(k, prompts=None, *, reqs=None, max_new=4, mode=BASE, **kw):
    eng = k.engine(mode, **kw)
    if reqs is None:
        reqs = [k.Request(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    return eng, sorted(done, key=lambda r: r.rid)


def _result(eng, done, **extra):
    return {"requests": _key(done), "counters": dict(eng.counters), **extra}


def _raises(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e).replace("—", "-"))
    return None


# --- scenarios: each returns what both packages must agree on ---------------

def deadline_queued(k, layout):
    reqs = [k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=8),
            k.Request(rid=1, prompt=_prompts([4], seed=1)[0],
                      max_new_tokens=8, deadline_steps=2)]
    eng, done = _serve(k, reqs=reqs, slots=1, max_len=16, kv_layout=layout,
                       kv_block_size=4)
    assert [r.finish_reason for r in done] == ["length", "deadline"]
    assert done[1].output == [] and done[1].s_done == 2
    return _result(eng, done)


def deadline_mid_decode(k, layout):
    kw = dict(slots=1, max_len=32, kv_layout=layout, kv_block_size=4)
    _, base = _serve(k, _prompts([5]), max_new=10, **kw)
    req = k.Request(rid=0, prompt=_prompts([5])[0], max_new_tokens=10,
                    deadline_steps=4)
    eng, done = _serve(k, reqs=[req], **kw)
    n = len(done[0].output)
    assert done[0].finish_reason == "deadline" and 0 < n < 10
    assert done[0].output == base[0].output[:n]
    return _result(eng, done, base=_key(base))


def deadline_validated(k):
    eng = k.engine(slots=1, max_len=16)
    return {"error": _raises(lambda: eng.submit(k.Request(
        rid=0, prompt=_prompts([4])[0], deadline_steps=0)))}


def overflow_sheds(k):
    eng = k.engine(slots=1, max_len=16, max_queue=2, kv_block_size=4)
    reqs = [k.Request(rid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(_prompts([4, 4, 4, 4]))]
    admitted = [eng.submit(r) for r in reqs]
    done = eng.run()
    assert admitted == [True, True, False, False]
    return _result(eng, done, admitted=admitted,
                   report=dict(eng.latency_report(done)["finish_reasons"]))


def max_queue_validated(k):
    return {"error": _raises(lambda: k.engine(slots=1, max_len=16,
                                              max_queue=0))}


PRE_KW = dict(slots=2, max_len=16, kv_block_size=4, kv_blocks=6)
PRE_BIG = dict(slots=2, max_len=16, kv_block_size=4, kv_blocks=16)


def recompute_identical(k):
    prompts = _prompts([4, 4])
    _, big = _serve(k, prompts, max_new=8, **PRE_BIG)
    eng, done = _serve(k, prompts, max_new=8, **PRE_KW)
    assert eng.counters["preempted"] >= 1
    assert [r.output for r in done] == [r.output for r in big]
    assert eng.free_blocks == eng.kv_blocks - 1
    assert eng.kv_report()["integrity_ok"]
    return _result(eng, done, big=_key(big))


def victim_lowest_priority(k):
    prompts = _prompts([4, 4])
    reqs = [k.Request(rid=0, prompt=prompts[0], max_new_tokens=8,
                      priority=0),
            k.Request(rid=1, prompt=prompts[1], max_new_tokens=8,
                      priority=1)]
    eng, done = _serve(k, reqs=reqs, **PRE_KW)
    assert done[0].n_preempts >= 1 and done[1].n_preempts == 0
    return _result(eng, done)


def preempt_false_terminal(k):
    eng, done = _serve(k, _prompts([4]), max_new=6, slots=1, max_len=16,
                       kv_block_size=2, kv_blocks=3, preempt=False)
    assert done[0].finish_reason == "cache_full"
    assert len(done[0].output) == 1
    return _result(eng, done)


def preempt_limit_pingpong(k):
    eng = k.engine(slots=1, max_len=16, kv_block_size=4, preempt_limit=1)
    eng.submit(k.Request(rid=0, prompt=_prompts([3])[0], max_new_tokens=8))
    done = []
    eng.step(done)
    req = eng.active[0]
    eng._preempt(0, req, done)
    assert req.n_preempts == 1 and not done
    eng.step(done)
    eng._preempt(0, eng.active[0], done)
    assert done and done[0].finish_reason == "cache_full"
    return _result(eng, done)


def transient_hold_waits(k):
    eng = k.engine(slots=1, max_len=16, kv_block_size=4, kv_blocks=4)
    held = eng.reserve_blocks(3)
    held_report = eng.kv_report()["kv_blocks_held"]
    eng.submit(k.Request(rid=0, prompt=_prompts([8])[0], max_new_tokens=3))
    done = []
    for _ in range(4):
        eng.step(done)
    waited = (len(done), len(eng.queue))
    eng.release_blocks(held)
    done = eng.run()
    assert waited == (0, 1) and done[0].finish_reason == "length"
    assert eng.kv_report()["integrity_ok"]
    return _result(eng, done, held=held, held_report=held_report,
                   waited=waited)


def unservable_terminal(k):
    eng, done = _serve(k, _prompts([9]), slots=1, max_len=16,
                       kv_block_size=4, kv_blocks=3)
    assert done[0].finish_reason == "cache_full" and done[0].output == []
    return _result(eng, done)


def reserve_requires_paged(k):
    eng = k.engine(slots=1, max_len=16, kv_layout="contiguous")
    return {"error": _raises(lambda: eng.reserve_blocks(1))}


def ladder_validation(k):
    cases = [(["olm16"], "olm16"), (["olm16", "olm7"], "olm16"),
             (["olm8", "olm16"], "olm16"), (["olm16", "olm8", "olm8"],
                                            "olm16")]
    errors = [_raises(lambda lad=lad, b=b: k.Ladder.build(lad, base_mode=b))
              for lad, b in cases]
    lad = k.Ladder.build(["olm16", "olm8"], base_mode="olm16")
    return {"errors": [(e[0], e[1].split(";")[0]) for e in errors],
            "ladder": (lad.rung_of("olm16"), lad.rung_of(None),
                       lad.next_mode(0), lad.next_mode(1),
                       lad.kv_pressure(1, 8), lad.kv_pressure(4, 8),
                       lad.kv_pressure(0, 0))}


def overflow_downshift(k):
    prompts = _prompts([4, 5, 6])
    eng = k.engine(slots=1, max_len=16, kv_block_size=4, max_queue=1,
                   degrade_ladder=[BASE, "olm8"], degrade_queue_headroom=1)
    reqs = [k.Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    admitted = [eng.submit(r) for r in reqs]
    done = eng.run()
    _, ded = _serve(k, [prompts[1]], mode="olm8", slots=1, max_len=16,
                    kv_block_size=4)
    done = sorted(done, key=lambda r: r.rid)
    assert admitted == [True, True, False]
    assert done[1].served_tier == "olm8" and done[1].degrade_rung == 1
    assert done[1].output == ded[0].output
    return _result(eng, done, admitted=admitted)


def preempt_downshift(k):
    eng = k.engine(slots=1, max_len=16, kv_block_size=4, kv_blocks=9,
                   degrade_ladder=[BASE, "olm8"], degrade_free_frac=0.5)
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=6))
    done = []
    eng.step(done)
    held = eng.reserve_blocks(eng.free_blocks)
    eng._preempt(0, eng.active[0], done)
    eng.release_blocks(held)
    done += eng.run()
    assert done[0].degrade_rung == 1 and done[0].served_tier == "olm8"
    return _result(eng, done)


def rung_collision(k):
    return {"error": _raises(lambda: k.engine(
        slots=1, max_len=16, quality_tiers={"olm8": BASE},
        degrade_ladder=[BASE, "olm8"]))}


def double_free(k):
    eng = k.engine(slots=1, max_len=16, kv_block_size=4)
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=8))
    eng.step([])
    owned = eng.owned_blocks(0)
    eng._free_slot_blocks(0)
    eng._owned[0] = owned
    return {"owned": owned,
            "error": _raises(lambda: eng._free_slot_blocks(0))}


def corrupted_free_list(k):
    eng = k.engine(slots=2, max_len=16, kv_block_size=4)
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=8))
    eng.step([])
    eng._free.append(eng.owned_blocks(0)[0])
    return {"error": _raises(lambda: eng._alloc_blocks(1, 1))}


def audit_repairs_active(k):
    kw = dict(slots=1, max_len=16, kv_block_size=4)
    _, base = _serve(k, _prompts([4]), max_new=8, **kw)
    eng = k.engine(integrity_audit=True, **kw)
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=8))
    done = []
    eng.step(done)
    eng.corrupt_table_entry(0, 0, eng.kv_blocks + 3)
    broken = eng.kv_report()["integrity_ok"]
    done += eng.run()
    assert not broken and eng.counters["table_repairs"] == 1
    assert done[0].output == base[0].output
    assert eng.kv_report()["integrity_ok"]
    return _result(eng, done)


def audit_rebuilds_idle(k):
    eng = k.engine(slots=2, max_len=16, kv_block_size=4,
                   integrity_audit=True)
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=4))
    done = []
    eng.step(done)
    eng.corrupt_table_entry(1, 0, eng.kv_blocks + 3)
    done += eng.run()
    assert eng.counters["table_repairs"] == 1 and done[0].n_preempts == 0
    assert eng.kv_report()["integrity_ok"]
    return _result(eng, done)


def decode_nan(k):
    kw = dict(slots=1, max_len=32, kv_block_size=4)
    _, base = _serve(k, _prompts([5]), max_new=8, **kw)
    eng = k.engine(numerics_check=True, **kw)
    calls = []

    def tap(lg, phase, step):
        if phase == "decode":
            calls.append(step)
            if len(calls) == 3:
                lg = lg.copy()
                lg[min(eng.active), :] = np.nan
        return lg

    eng.logits_tap = tap
    eng.submit(k.Request(rid=0, prompt=_prompts([5])[0], max_new_tokens=8))
    done = eng.run()
    assert done[0].finish_reason == "numerics"
    assert done[0].output == base[0].output[:3]
    assert eng.free_blocks == eng.kv_blocks - 1
    return _result(eng, done, taps=calls)


def prefill_nan(k):
    eng = k.engine(slots=2, max_len=16, kv_block_size=4, numerics_check=True)

    def tap(lg, phase, step):
        if phase == "prefill":
            lg = lg.copy()
            lg[0, :] = np.inf
        return lg

    eng.logits_tap = tap
    eng.submit(k.Request(rid=0, prompt=_prompts([4])[0], max_new_tokens=4))
    done = eng.run()
    assert done[0].finish_reason == "numerics" and done[0].output == []
    assert done[0].t_first is None
    assert eng.free_blocks == eng.kv_blocks - 1
    assert eng.kv_report()["integrity_ok"]
    return _result(eng, done)


def numerics_off_by_default(k):
    eng = k.engine(slots=1, max_len=16)
    return {"defaults": (eng.numerics_check, eng.logits_tap, eng.preempt,
                         eng.preempt_limit, eng.integrity_audit,
                         eng.prefill_retries, eng.prefill_backoff,
                         eng.max_queue, eng.degrade, eng.prefill_chunk)}


def lattice(k, layout, tier):
    tiers = {"fast": "olm8"} if tier else None
    kw = dict(slots=1, max_len=16, kv_layout=layout, kv_block_size=4,
              quality_tiers=tiers)
    prompts = _prompts([4, 5, 12, 4, 4, 4])
    _, probe = _serve(k, reqs=[k.Request(rid=0, prompt=prompts[1],
                                         max_new_tokens=6,
                                         quality_tier=tier)], **kw)
    eos = probe[0].output[1]
    reqs = [
        k.Request(rid=0, prompt=prompts[0], max_new_tokens=3,
                  quality_tier=tier),
        k.Request(rid=1, prompt=prompts[1], max_new_tokens=6, eos_id=eos,
                  quality_tier=tier),
        k.Request(rid=2, prompt=prompts[2], max_new_tokens=20,
                  quality_tier=tier),
        k.Request(rid=3, prompt=prompts[3], max_new_tokens=3,
                  deadline_steps=2, quality_tier=tier),
        k.Request(rid=4, prompt=prompts[4], max_new_tokens=3,
                  quality_tier=tier),
        k.Request(rid=5, prompt=prompts[5], max_new_tokens=3,
                  quality_tier=tier),
    ]
    eng, done = _serve(k, reqs=reqs, max_queue=4, **kw)
    by_rid = {r.rid: r.finish_reason for r in done}
    assert by_rid == {0: "length", 1: "eos", 2: "max_len", 3: "deadline",
                      4: "rejected", 5: "rejected"}
    rep = eng.latency_report(done)
    assert dict(eng.counters) == rep["finish_reasons"]
    want_mode = "olm8" if tier else BASE
    assert all(r.served_tier == want_mode for r in done if r.output)
    return _result(eng, done, probe=_key(probe))


def chunked_identical(k):
    prompts = _prompts([10, 3, 7])
    kw = dict(max_new=4, slots=2, max_len=16, kv_block_size=4, kv_blocks=11)
    _, plain = _serve(k, prompts, **kw)
    eng, chunked = _serve(k, prompts, prefill_chunk=4, **kw)
    assert [r.output for r in plain] == [r.output for r in chunked]
    return _result(eng, chunked, plain=_key(plain),
                   traces=eng.prefill_traces,
                   refused=_raises(lambda: k.engine(slots=1, max_len=16,
                                                    prefill_chunk=5)))


SCENARIOS = {
    "TestDeadlines::expires_while_queued[paged]":
        lambda k: deadline_queued(k, "paged"),
    "TestDeadlines::expires_while_queued[contiguous]":
        lambda k: deadline_queued(k, "contiguous"),
    "TestDeadlines::mid_decode_clean_prefix[paged]":
        lambda k: deadline_mid_decode(k, "paged"),
    "TestDeadlines::mid_decode_clean_prefix[contiguous]":
        lambda k: deadline_mid_decode(k, "contiguous"),
    "TestDeadlines::deadline_validated": deadline_validated,
    "TestBackpressure::overflow_sheds_rejected": overflow_sheds,
    "TestBackpressure::max_queue_validated": max_queue_validated,
    "TestPreemption::recompute_is_bit_identical": recompute_identical,
    "TestPreemption::victim_is_lowest_priority": victim_lowest_priority,
    "TestPreemption::preempt_false_terminal_cache_full":
        preempt_false_terminal,
    "TestPreemption::preempt_limit_bounds_pingpong": preempt_limit_pingpong,
    "TestAdmissionDeadlockGuard::transient_hold_waits": transient_hold_waits,
    "TestAdmissionDeadlockGuard::unservable_prompt_terminal":
        unservable_terminal,
    "TestAdmissionDeadlockGuard::reserve_requires_paged":
        reserve_requires_paged,
    "TestDegradeLadder::build_validation": ladder_validation,
    "TestDegradeLadder::overflow_downshift_matches_dedicated":
        overflow_downshift,
    "TestDegradeLadder::preempt_downshift_under_kv_pressure":
        preempt_downshift,
    "TestDegradeLadder::rung_collision_with_quality_tier": rung_collision,
    "TestIntegrityGuards::double_free_raises": double_free,
    "TestIntegrityGuards::corrupted_free_list_detected": corrupted_free_list,
    "TestIntegrityGuards::audit_repairs_active_lane": audit_repairs_active,
    "TestIntegrityGuards::audit_rebuilds_idle_lane": audit_rebuilds_idle,
    "TestNumericsGuard::decode_nan_clean_prefix": decode_nan,
    "TestNumericsGuard::prefill_nan_never_activates": prefill_nan,
    "TestNumericsGuard::off_by_default": numerics_off_by_default,
    **{f"TestFinishReasonLattice::all_reasons[{layout}-{tier}]":
       (lambda k, layout=layout, tier=tier: lattice(k, layout, tier))
       for layout in ("paged", "contiguous") for tier in (None, "fast")},
    "TestChunkedPrefill::chunked_identical_to_unchunked": chunked_identical,
}


def _comparable(result):
    """Error messages compared up to the registry listing, which names
    each package's own modes."""
    if isinstance(result, dict):
        return {k: _comparable(v) for k, v in result.items()}
    if isinstance(result, tuple) and len(result) == 2 \
            and isinstance(result[1], str):
        return (result[0], result[1].split("(have")[0])
    if isinstance(result, list):
        return [_comparable(v) for v in result]
    return result


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_matches_reference(kits, name):
    jkit, tkit = kits
    want = SCENARIOS[name](jkit)
    got = SCENARIOS[name](tkit)
    assert _comparable(got) == _comparable(want)
