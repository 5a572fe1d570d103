"""The port's ServeEngine against the JAX reference engine: both serve the
same seeded requests under dot_mode="olm16" on bridged weights at the
smoke size with f32 compute, and must give the same greedy token streams,
finish reasons and KV byte counts. Plus the port's own paged-vs-contiguous
identity and allocator bookkeeping.

The pool is sized by the engines' default, which holds every request at
once: the reference would preempt under block pressure, and preemption is
not ported yet.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine

ARCH = "internlm2_1_8b"
KV_KEYS = ("kv_bytes_resident", "kv_bytes_contiguous", "kv_block_size",
           "kv_blocks_usable", "kv_blocks_free", "kv_blocks_peak_used")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(rng.integers(3, 7))).astype(np.int32)
            for _ in range(n)]


def _serve(engine, request_cls, prompts, max_new, eos_id=None):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new,
                                  eos_id=eos_id))
    return sorted(engine.run(), key=lambda r: r.rid)


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
    # The reference's olm GEMMs run its TPU kernel in interpret mode
    # (bit-identical to its broadcast oracle, and quicker to compile).
    jm = JModel(jcfg, JEngine(use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    kw = dict(slots=4, max_len=32, kv_block_size=4)
    jeng = JServeEngine(jm, jp, dot_mode="olm16", **kw)
    teng = ServeEngine(tm, tp, dot_mode="olm16", device="cpu", **kw)
    prompts = _prompts()
    jdone = _serve(jeng, JRequest, prompts, max_new=4)
    tdone = _serve(teng, Request, prompts, max_new=4)
    return jeng, jdone, teng, tdone


def test_token_streams_equal_reference(served):
    _, jdone, _, tdone = served
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert all(len(r.output) == 4 for r in tdone)


def test_finish_reasons_equal_reference(served):
    _, jdone, _, tdone = served
    assert [r.finish_reason for r in tdone] == [r.finish_reason for r in jdone]


def test_kv_report_bytes_equal_reference(served):
    jeng, _, teng, _ = served
    jrep, trep = jeng.kv_report(), teng.kv_report()
    assert {k: trep[k] for k in KV_KEYS} == {k: jrep[k] for k in KV_KEYS}
    assert trep["integrity_ok"]
    assert trep["kv_blocks_free"] == trep["kv_blocks_usable"]


def test_engine_serves_olm16_through_dot_mode(served):
    _, _, teng, _ = served
    assert teng.model.eng.mode == "olm16"


def _small():
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32",
                              n_layers=1)
    model = Model(cfg, device="cpu")
    return model, model.init(seed=2)


@pytest.mark.parametrize("mode", ["native", "olm8"])
def test_paged_matches_contiguous(mode):
    model, params = _small()
    prompts = _prompts(1, 3)
    kw = dict(slots=2, max_len=16, dot_mode=mode, device="cpu")
    paged = _serve(ServeEngine(model, params, kv_layout="paged",
                               kv_block_size=4, kv_blocks=9, **kw),
                   Request, prompts, max_new=4)
    contig = _serve(ServeEngine(model, params, kv_layout="contiguous", **kw),
                    Request, prompts, max_new=4)
    assert [r.output for r in paged] == [r.output for r in contig]


def test_eos_and_max_len_finish():
    model, params = _small()
    prompt = _prompts(2, 1)[0]
    eng = ServeEngine(model, params, slots=1, max_len=16, device="cpu")
    first = _serve(eng, Request, [prompt], max_new=3)[0]
    eng = ServeEngine(model, params, slots=1, max_len=16, device="cpu")
    eos_id = first.output[1]
    eos = _serve(eng, Request, [prompt], max_new=8, eos_id=eos_id)[0]
    stop = first.output.index(eos_id) + 1
    assert eos.finish_reason == "eos" and eos.output == first.output[:stop]
    eng = ServeEngine(model, params, slots=1, max_len=len(prompt) + 3,
                      device="cpu")
    long = _serve(eng, Request, [prompt], max_new=50)[0]
    assert long.finish_reason == "max_len"


def test_blocks_return_to_the_pool():
    model, params = _small()
    eng = ServeEngine(model, params, slots=2, max_len=16, kv_block_size=4,
                      device="cpu")
    done = _serve(eng, Request, _prompts(3, 3), max_new=3)
    rep = eng.kv_report()
    assert len(done) == 3 and rep["integrity_ok"]
    assert rep["kv_blocks_free"] == rep["kv_blocks_usable"]
    assert 0 < rep["kv_blocks_peak_used"] <= rep["kv_blocks_usable"]
    assert rep["kv_bytes_resident"] < rep["kv_bytes_contiguous"]


def test_prompt_length_validated():
    model, params = _small()
    eng = ServeEngine(model, params, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32)))


def test_latency_report_counts_tokens():
    model, params = _small()
    eng = ServeEngine(model, params, slots=2, max_len=16, device="cpu")
    done = _serve(eng, Request, _prompts(4, 2), max_new=2)
    rep = ServeEngine.latency_report(done)
    assert rep["n"] == 2 and rep["new_tokens"] == 4
    assert rep["finish_reasons"] == {"length": 2} and rep["n_length"] == 2
    assert torch.isfinite(torch.tensor(rep["tokens_per_s"]))
