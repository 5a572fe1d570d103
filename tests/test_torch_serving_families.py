"""The port's ServeEngine against the reference engine on the recurrent
and MoE families: RecurrentGemma-9B (RG-LRU layers and windowed MQA
rings), Mamba2-130M (SSD layers only: no layer is paged) and
Mixtral-8x22B (MoE, window) at `smoke_config` with f32 compute, native,
under the paged and the contiguous layout (RecurrentGemma also under
olm16, the reference's olm GEMMs through its kernel in interpret mode),
on bridged weights.

Such a model prefills each request alone at its exact length (bucketing
off: a pad tail would advance a recurrent state or wrap a ring), scatters
every leaf of a recurrent state (h, conv) into the lane it activates,
counts only attention K/V in kv_report, and refuses prefill_chunk. Five
requests on two lanes: lanes serve one request after another, whose
states the activation scatter resets (idle lanes step their states too).
The paged engine's default pool is too small for the two longest
prompts at once, so lanes are preempted and their requests recomputed.
Per request the (output, finish_reason, n_preempts, s_done) must be
equal, and so must the counters, the trace counts and kv_report.
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
from repro_torch.core.numerics import DotEngine
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine

VOCAB = 512
PROMPTS = (5, 12, 20, 3, 9)
ENGINES = {
    "paged": dict(slots=2, max_len=32, kv_layout="paged", kv_block_size=4),
    "contiguous": dict(slots=2, max_len=32, kv_layout="contiguous"),
}
CASES = ([(a, "native", lay) for a in ("recurrentgemma_9b", "mamba2_130m",
                                        "mixtral_8x22b")
          for lay in sorted(ENGINES)]
         + [("recurrentgemma_9b", "olm16", "paged")])
# olm16 serves the two shortest prompts, 4 new tokens each: both
# packages' olm GEMMs are slow on the CPU
OLM_PROMPTS = (5, 3)


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


_KITS = {}


def kits(arch, mode):
    """(reference kit, port kit) on the same weights, built once each;
    under olm16 one pattern group (its olm GEMMs are slow on the CPU)."""
    if (arch, mode) not in _KITS:
        over = dict(compute_dtype="float32")
        if mode == "olm16":
            over["n_layers"] = len(smoke_config(arch).block_pattern)
        jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
        cfg = dataclasses.replace(smoke_config(arch), **over)
        # the reference's olm GEMMs run its TPU kernel in interpret mode
        jm = JModel(jcfg, JEngine(mode=mode, use_pallas=True))
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        tm = Model(cfg, DotEngine(mode=mode), device="cpu")
        _KITS[arch, mode] = ((jm, jp, JRequest, JServeEngine),
                             (tm, tp, Request, ServeEngine))
    return _KITS[arch, mode]


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lens]


def _serve(kit, *, max_new=6, prompts=PROMPTS, **kw):
    model, params, Req, Engine = kit
    if Engine is ServeEngine:
        kw["device"] = "cpu"
    eng = Engine(model, params, **kw)
    for i, p in enumerate(_prompts(prompts)):
        eng.submit(Req(rid=i, prompt=p, max_new_tokens=max_new))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return eng, done


def _key(eng, done):
    return {"requests": [(r.rid, list(r.output), r.finish_reason,
                          r.n_preempts, r.s_done) for r in done],
            "counters": dict(eng.counters),
            "traces": (eng.prefill_traces, eng.decode_traces),
            "kv": dict(eng.kv_report())}


@pytest.mark.parametrize("arch,mode,layout", CASES,
                         ids=lambda v: str(v))
def test_engine_matches_reference(_compile_cache, arch, mode, layout):
    jkit, tkit = kits(arch, mode)
    olm = mode == "olm16"
    kw = dict(max_new=4 if olm else 6, prompts=OLM_PROMPTS if olm else PROMPTS,
              **ENGINES[layout])
    jeng, jdone = _serve(jkit, **kw)
    teng, tdone = _serve(tkit, **kw)
    assert _key(teng, tdone) == _key(jeng, jdone)
    assert len(tdone) == len(kw["prompts"])
    assert all(r.finish_reason == "length" for r in tdone)
    # exact-length prefill, one request a call: a prefill shape per
    # distinct prompt length (and per recompute length after a preemption)
    assert not teng._bucketed and not jeng._bucketed
    assert teng.prefill_traces >= len(set(kw["prompts"]))
    if layout == "paged" and not olm:   # the pool holds 8 blocks of 4
        assert teng.counters["preempted"] >= 1
    cfg = teng.model.cfg
    for kind, c in zip(cfg.layer_kinds, teng.cache):
        want = {"h", "conv"} if kind in ("rec", "ssm") else {"k", "v"}
        assert set(c) == want
        if kind in ("rec", "ssm"):
            assert all(t.dtype == torch.float32 for t in c.values())


def test_state_scatter_resets_a_reused_lane():
    # a lane's state after serving one request and then another equals a
    # fresh lane's state after the second alone: the activation scatter
    # writes every leaf of the recurrent state
    _, (tm, tp, _, _) = kits("mamba2_130m", "native")
    prompts = _prompts((7, 4, 11))
    eng = ServeEngine(tm, tp, slots=1, max_len=32, device="cpu")
    for i, p in enumerate(prompts[:2]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.run()
    fresh = ServeEngine(tm, tp, slots=1, max_len=32, device="cpu")
    for eng_ in (eng, fresh):
        eng_.submit(Request(rid=9, prompt=prompts[2], max_new_tokens=1))
        eng_.run()
    for a, b in zip(eng.cache, fresh.cache):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_130m"])
def test_kv_report_counts_attention_layers_only(arch):
    _, (tm, tp, _, Engine) = kits(arch, "native")
    rep = Engine(tm, tp, slots=2, max_len=32, device="cpu").kv_report()
    cfg = tm.cfg
    T = min(32, cfg.sliding_window or 32)
    per_layer = 2 * 2 * T * cfg.n_kv_heads * cfg.head_dim * 4   # k+v, f32
    assert rep["kv_bytes_contiguous"] == rep["kv_bytes_resident"] == \
        cfg.layer_kinds.count("attn") * per_layer
    if arch == "mamba2_130m":
        assert rep["kv_bytes_resident"] == 0 and rep["integrity_ok"]


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_130m"])
def test_prefill_chunk_raises_as_in_the_reference(arch):
    for model, params, _, Engine in kits(arch, "native"):
        kw = {"device": "cpu"} if Engine is ServeEngine else {}
        with pytest.raises(ValueError, match="attention-only"):
            Engine(model, params, slots=2, max_len=32, prefill_chunk=8, **kw)


def test_no_block_table_without_a_paged_layer():
    _, (tm, tp, _, Engine) = kits("recurrentgemma_9b", "native")
    eng = Engine(tm, tp, slots=2, max_len=32, device="cpu")
    assert eng._table_dev is None
    assert all("table" not in c for c in eng.cache)
