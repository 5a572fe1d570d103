"""The port's ServeEngine against the reference engine on a sliding-window
model: a tiny dense config with a window of 8 (and ChatGLM3's QKV bias and
half RoPE), both engines under dot_mode="olm16" at f32 compute on bridged
weights, as test_torch_serving_robustness.py runs them, where the two are
bit-identical.

A windowed model prefills each request alone at its exact length
(bucketing off: a pad tail longer than the window would wrap the ring),
keeps its ring caches contiguous under the paged layout, counts ring
bytes in kv_report, and refuses prefill_chunk. Prompts run shorter than,
as long as and longer than the window, and decode wraps the ring. Per
request the (output, finish_reason, n_preempts, s_done) must be equal,
and so must the counters, the trace counts and kv_report.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.numerics import DotEngine as JEngine
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine

VOCAB = 512
WINDOW = 8
CFG = dict(name="t-swa", family="dense", n_layers=2, d_model=16, n_heads=2,
           n_kv_heads=2, d_ff=32, vocab_size=VOCAB, qkv_bias=True,
           rope_style="half", sliding_window=WINDOW, param_dtype="float32",
           compute_dtype="float32")
PROMPTS = (5, 8, 13, 3, 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def _compile_cache(tmp_path_factory):
    # exact-length prefill compiles once per prompt length in the
    # reference: its persistent cache lets the cases share the programs
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


@pytest.fixture(scope="module")
def models(_compile_cache):
    jcfg, cfg = JConfig(**CFG), ModelConfig(**CFG)
    jm = JModel(jcfg, JEngine(mode="olm16", use_pallas=False))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for key in ("bq", "bk", "bv"):   # the reference inits them to zero
        b = jp["blocks"]["scan"][0]["attn"][key]
        jp["blocks"]["scan"][0]["attn"][key] = jax.numpy.asarray(
            0.5 * rng.standard_normal(b.shape), b.dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tm = Model(cfg, DotEngine(mode="olm16"), device="cpu")
    return (jm, jp, JRequest, JServeEngine), (tm, tp, Request, ServeEngine)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lens]


def _serve(kit, *, max_new=10, **kw):
    model, params, Req, Engine = kit
    if Engine is ServeEngine:
        kw["device"] = "cpu"
    eng = Engine(model, params, **kw)
    for i, p in enumerate(_prompts(PROMPTS)):
        eng.submit(Req(rid=i, prompt=p, max_new_tokens=max_new))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return eng, done


def _key(eng, done):
    rep = dict(eng.kv_report())
    return {"requests": [(r.rid, list(r.output), r.finish_reason,
                          r.n_preempts, r.s_done) for r in done],
            "counters": dict(eng.counters),
            "traces": (eng.prefill_traces, eng.decode_traces),
            "kv": rep}


ENGINES = {
    "paged": dict(slots=2, max_len=32, kv_layout="paged", kv_block_size=4),
    "contiguous": dict(slots=2, max_len=32, kv_layout="contiguous"),
    # a pool too small for both lanes: preemption and recompute
    "paged-preempting": dict(slots=2, max_len=32, kv_layout="paged",
                             kv_block_size=4, kv_blocks=9),
}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_windowed_engine_matches_reference(models, case):
    jkit, tkit = models
    jeng, jdone = _serve(jkit, **ENGINES[case])
    teng, tdone = _serve(tkit, **ENGINES[case])
    want, got = _key(jeng, jdone), _key(teng, tdone)
    assert got == want
    assert len(tdone) == len(PROMPTS)
    assert not teng._bucketed and not jeng._bucketed
    # exact-length prefill, one request a call: a prefill shape per
    # distinct prompt length, and a ring of WINDOW slots per layer
    assert teng.prefill_traces >= len(set(PROMPTS))
    assert all(set(c) == {"k", "v"} and c["k"].shape[1] == WINDOW
               for c in teng.cache)
    if case == "paged-preempting":
        assert teng.counters["preempted"] >= 1


def test_ring_bytes_in_kv_report(models):
    _, (tm, tp, _, Engine) = models
    eng = Engine(tm, tp, slots=2, max_len=32, device="cpu")
    rep = eng.kv_report()
    per_layer = 2 * 2 * WINDOW * 2 * 8 * 4       # k+v, lanes, slots, H, D, f32
    assert rep["kv_bytes_resident"] == rep["kv_bytes_contiguous"] \
        == CFG["n_layers"] * per_layer


def test_prefill_chunk_raises_as_in_the_reference(models):
    # both refuse it at construction (the reference's message names the
    # unbucketed pattern, the port's the window: the port's only cause)
    for model, params, _, Engine in models:
        kw = {"device": "cpu"} if Engine is ServeEngine else {}
        with pytest.raises(ValueError, match="prefill_chunk"):
            Engine(model, params, slots=2, max_len=32, prefill_chunk=8, **kw)
    model, params, _, Engine = models[1]
    with pytest.raises(ValueError, match="sliding_window"):
        Engine(model, params, slots=2, max_len=32, prefill_chunk=8,
               device="cpu")
