"""The port's autotuner (`repro_torch/kernels/online_dot/tuning.py`)
against the reference's (`repro/kernels/online_dot/tuning.py`), after
tests/test_fused_quantize_autotune.py's tuner tests: the numerics half
(buckets, keys, decode windows, the pinned k_tile) equal to the
reference's; the cache's miss -> memoized -> hit accounting call for call;
memoization off disk; the port's own environment variable; a stale k_tile
re-pinned, another card's entries unread and an illegal entry re-planned;
the heuristic equal to K1's planner and every candidate legal at every
serve shape of every config; `tiling="auto"` and pinned blocks
bit-identical to the reference's engines (its TPU kernel in interpret
mode) with equal hit and miss counts; the serve under dot_tiling="auto"
token for token; `engine_for`'s fields (F2) and pinned blocks reaching the
planner (F3); `tune` on the CPU (the plain version, which ignores plans)
writing a card-named entry. Everything here runs on the CPU.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olm_array as jolm
from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.kernels.online_dot import tuning as jtuning
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, list_archs, olm_array, \
    smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine, TRUNCATED_SPECS
from repro_torch.kernels.online_dot import matmul, matmul_kernel, tuning
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine

WIDTHS = [(n, None) for n in (8, 16, 24, 32)] + list(TRUNCATED_SPECS)
FIELDS = ("mode", "k_tile", "block_m", "block_n", "tiling", "layer_modes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' default caches pointed at fresh files (the port's
    for the CPU, which is the card this process serves)."""
    jc = jtuning.TuningCache(str(tmp_path / "ref.json"))
    tc = tuning.TuningCache(str(tmp_path / "port.json"))
    monkeypatch.setattr(jtuning, "_DEFAULT_CACHE", jc)
    monkeypatch.setattr(tuning, "_DEFAULT_CACHE", tc)
    return jc, tc


# ------------------------------------------------------ the numerics half

@pytest.mark.parametrize("n,trunc", WIDTHS, ids=str)
def test_numerics_half_equals_the_reference(n, trunc):
    for M in (1, 3, 4, 64, 100, 4096):
        for N in (1, 37, 256, 92544):
            for K in (1, 3, 16, 17, 2048, 13696):
                assert tuning.bucket_key(M, N, K, n, trunc) == \
                    jtuning.bucket_key(M, N, K, n, trunc)
                assert tuning.pinned_k_tile(K, n) == \
                    jtuning.pinned_k_tile(K, n)
                if trunc is not None:
                    assert tuning.pinned_k_tile(K, trunc) == \
                        jtuning.pinned_k_tile(K, trunc)
        assert tuning.bucket(M) == jtuning.bucket(M)
    assert tuning.decode_window(n) == jtuning.decode_window(n)
    assert tuning.max_k_tile(n) == jtuning.max_k_tile(n)
    # the numerics knob of every heuristic is the reference's
    for shape in ((1, 4096, 4096), (4, 11, 3), (128, 128, 128)):
        assert tuning.heuristic_tiling(*shape, n, trunc).k_tile == \
            jtuning.heuristic_tiling(*shape, n, trunc).k_tile


# ------------------------------------------------------------ the cache

SEQUENCE = [(64, 64, 256, 16, None), (64, 64, 256, 16, None),
            (63, 64, 255, 16, None), (1, 64, 256, 16, None),
            (1, 64, 256, 16, 12), (64, 64, 256, 32, 16),
            (1, 64, 256, 16, 12), (4, 2048, 2048, 8, None)]


def test_miss_memoizes_then_hits_as_the_reference(tmp_path):
    jc = jtuning.TuningCache(str(tmp_path / "ref.json"))
    tc = tuning.TuningCache(str(tmp_path / "port.json"))
    for M, N, K, n, p in SEQUENCE:
        got = tuning.get_tiling(M, N, K, n, tc, trunc=p)
        want = jtuning.get_tiling(M, N, K, n, jc, trunc=p)
        assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
        assert got["k_tile"] == want["k_tile"]
        assert got == tuning.heuristic_tiling(M, N, K, n, p).as_dict()
    assert (tc.hits, tc.misses) == (3, 5)


def test_memoization_stays_off_disk(tmp_path):
    path = tmp_path / "t.json"
    tuning.get_tiling(8, 8, 16, 16, tuning.TuningCache(str(path)))
    assert not path.exists()


def test_port_variable_points_the_default_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.delenv(tuning.CACHE_ENV, raising=False)
    monkeypatch.setattr(tuning, "_DEFAULT_CACHE", None)
    assert tuning.default_cache().path == tuning.DEFAULT_CACHE_PATH
    assert tuning.DEFAULT_CACHE_PATH.endswith("results/tuning_torch.json")
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "env.json"))
    monkeypatch.setattr(tuning, "_DEFAULT_CACHE", None)
    assert tuning.default_cache().path == str(tmp_path / "env.json")


def _write(path, card, entries):
    path.write_text(json.dumps({"card": {"name": card, "power_limit": None,
                                         "sms": 132}, "entries": entries}))


def test_stale_k_tile_is_repinned_on_read(tmp_path):
    path = tmp_path / "t.json"
    entry = {"k_tile": 4, "block_m": 2, "block_n": 4, "tb": 4,
             "source": "measured", "shape": [8, 8, 32], "n_bits": 16}
    _write(path, "cpu", {tuning.bucket_key(8, 8, 32, 16): entry})
    d = tuning.get_tiling(8, 8, 32, 16, tuning.TuningCache(str(path)))
    assert d["k_tile"] == 16                                 # re-pinned
    assert (d["block_m"], d["block_n"], d["tb"]) == (2, 4, 4)  # honored


def test_entries_of_another_card_are_not_read(tmp_path):
    path = tmp_path / "t.json"
    entry = {"k_tile": 16, "block_m": 2, "block_n": 4, "tb": 4,
             "source": "measured", "shape": [8, 8, 32], "n_bits": 16}
    _write(path, "NVIDIA H100 80GB HBM3", {tuning.bucket_key(8, 8, 32, 16):
                                           entry})
    other = tuning.TuningCache(str(path), card="cpu")
    d = tuning.get_tiling(8, 8, 32, 16, other)
    assert (other.hits, other.misses) == (0, 1)
    assert d == tuning.heuristic_tiling(8, 8, 32, 16).as_dict()
    same = tuning.TuningCache(str(path), card="NVIDIA H100 80GB HBM3")
    d = tuning.get_tiling(8, 8, 32, 16, same)
    assert (same.hits, same.misses) == (1, 0)
    assert (d["block_m"], d["block_n"], d["tb"]) == (2, 4, 4)


@pytest.mark.parametrize("blocks", [(64, 64, 1), (1, 1, 1), (3, 8, 8),
                                    (8, 8, None)])
def test_an_illegal_entry_is_replanned(tmp_path, blocks):
    path = tmp_path / "t.json"
    bm, bn, tb = blocks
    entry = {"k_tile": 16, "block_m": bm, "block_n": bn, "source": "measured",
             "shape": [64, 2048, 2048], "n_bits": 16}
    if tb is not None:
        entry["tb"] = tb
    _write(path, "cpu", {tuning.bucket_key(64, 2048, 2048, 16): entry})
    cache = tuning.TuningCache(str(path))
    d = tuning.get_tiling(64, 2048, 2048, 16, cache)
    assert d == tuning.heuristic_tiling(64, 2048, 2048, 16).as_dict()
    assert cache.hits == 1


def test_legality_counts_threads_and_each_kernels_stage():
    assert tuning.legal(tuning.Tiling(16, 8, 32, 1), 16)
    assert not tuning.legal(tuning.Tiling(16, 8, 64, 1), 16)   # 512 threads
    assert not tuning.legal(tuning.Tiling(16, 1, 4, 4), 16)    # 16 threads
    assert not tuning.legal(tuning.Tiling(16, 3, 32, 1), 16)   # not pow2
    # K2 stages 16 digit rows a slice: a 1 x 1 x 256 block fits K1's stage
    # and not K2's at n = 32, under either row layout
    assert tuning.legal(tuning.Tiling(16, 1, 1, 256), 32)
    assert not any(matmul_kernel.fits(32, True, vec, 1, 1, 256)
                   for vec in (False, True))


# ------------------------------------------- heuristic and candidates

@pytest.mark.parametrize("arch", list_archs())
def test_heuristic_is_the_planner_and_every_candidate_legal(arch):
    shapes = tuning.gemm_shapes(get_config(arch))
    assert shapes
    for K, N in shapes:
        for M in (4, 64):
            for n, p in ((16, None), (32, None), (16, 12), (8, None)):
                work = n if p is None else p
                plan = matmul_kernel.launch_plan(M, N, K, work)
                h = tuning.heuristic_tiling(M, N, K, n, p)
                assert (h.block_m, h.block_n, h.tb) == (plan.bm, plan.bn,
                                                        plan.tb)
                cands = tuning._candidates(M, N, K, n, p)
                assert h in cands and len(cands) == len(set(cands)) >= 2
                for c in cands:
                    assert tuning.legal(c, n, p)
                    assert c.k_tile == tuning.pinned_k_tile(K, work)


def test_cli_covers_the_launch_shapes_and_every_served_config():
    launch = tuning._launch_gemms()
    assert launch == jtuning._launch_gemms()
    # the eng.dot (K, N) each pass issues (chip_smoke.py checks K1 at each)
    assert tuning.gemm_shapes(get_config("internlm2_1_8b")) == sorted(
        {(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
         (2048, 92672)})
    assert tuning.gemm_shapes(get_config("mamba2_130m")) == [
        (768, 3352), (768, 50432), (1536, 768)]
    assert tuning.gemm_shapes(get_config("mixtral_8x22b")) == [
        (6144, 1024), (6144, 6144), (6144, 32768)]
    assert tuning.gemm_shapes(get_config("seamless_m4t_medium")) == [
        (1024, 1024), (1024, 4096), (1024, 256256), (4096, 1024)]
    serve = set(tuning._serve_gemms())
    for arch in list_archs():
        for K, N in tuning.gemm_shapes(get_config(arch)):
            assert {(4, N, K), (64, N, K)} <= serve


# ----------------------------------------- bits through the engines

def _pair(rng, M, K, N):
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mode", ["olm8", "olm16", "olm24", "olm32",
                                  "olm16t12", "olm32t20"])
def test_auto_and_pinned_blocks_give_the_references_bits(mode, caches):
    jc, tc = caches
    rng = np.random.default_rng(5)
    for K in (3, 17, 33):
        x, w = _pair(rng, 3, K, 5)
        want = np.asarray(JEngine(mode=mode, use_pallas=True,
                                  tiling="auto").dot(jnp.asarray(x),
                                                     jnp.asarray(w)))
        for eng in (DotEngine(mode=mode, tiling="auto"),
                    DotEngine(mode=mode, block_m=2, block_n=4),
                    DotEngine(mode=mode, tiling="auto", block_m=1)):
            got = eng.dot(torch.from_numpy(x), torch.from_numpy(w)).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
    # the port looked up twice a K (two auto engines), the reference once
    assert (tc.hits + tc.misses) == 2 * (jc.hits + jc.misses)
    assert tc.misses == jc.misses == len({tuning.bucket_key(3, 5, K, 16)
                                          for K in (3, 17, 33)})


def test_serve_under_auto_tiling_matches_the_reference(caches):
    jc, tc = caches
    arch = "internlm2_1_8b"
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    jm = JModel(jcfg, JEngine(use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    kw = dict(slots=2, max_len=16, kv_block_size=4, dot_mode="olm16",
              dot_tiling="auto")
    jeng = JServeEngine(jm, jp, **kw)
    teng = ServeEngine(tm, tp, device="cpu", **kw)
    assert teng.model.eng.tiling == "auto" == jeng.model.eng.tiling
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 512, 4).astype(np.int32) for _ in range(2)]
    out = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for rid, p in enumerate(prompts):
            eng.submit(req(rid=rid, prompt=p, max_new_tokens=3))
        out.append([r.output for r in sorted(eng.run(), key=lambda r: r.rid)])
    assert out[0] == out[1] and all(len(o) == 3 for o in out[1])
    # the port looks up every GEMM (the reference once a jit trace)
    assert tc.misses == len(tc._load()) > 0 and tc.hits > tc.misses


# ------------------------------------------------------------- F2, F3

@pytest.mark.parametrize("n,trunc", WIDTHS, ids=str)
@pytest.mark.parametrize("tiling", ["auto", None])
def test_engine_for_builds_the_references_engine(n, trunc, tiling):
    got = olm_array.engine_for(n, trunc=trunc, tiling=tiling)
    want = jolm.engine_for(n, trunc=trunc, tiling=tiling)
    assert {f: getattr(got, f) for f in FIELDS} == \
        {f: getattr(want, f) for f in FIELDS}
    gs, ws = got.spec(), want.spec()
    assert {f: getattr(gs, f) for f in FIELDS} == \
        {f: getattr(ws, f) for f in FIELDS}
    assert olm_array.MATMUL_TILING == jolm.MATMUL_TILING


def test_pinned_blocks_reach_the_planner(monkeypatch, caches):
    seen = []
    real = matmul.olm_matmul

    def spy(*a, **kw):
        seen.append({k: kw.get(k) for k in ("block_m", "block_n", "tb",
                                            "k_tile")})
        return real(*a, **kw)

    monkeypatch.setattr(matmul, "olm_matmul", spy)
    x, w = torch.ones(4, 32), torch.ones(32, 8)
    DotEngine(mode="olm16", block_m=2, block_n=4).dot(x, w)
    olm_array.engine_for(16, tiling=None).dot(x, w)
    DotEngine(mode="olm16", tiling="auto", block_m=1).dot(x, w)
    auto = tuning.heuristic_tiling(4, 8, 32, 16)
    assert seen == [dict(block_m=2, block_n=4, tb=None, k_tile=None),
                    dict(block_m=8, block_n=8, tb=None, k_tile=16),
                    dict(block_m=1, block_n=auto.block_n, tb=auto.tb,
                         k_tile=16)]
    plan = matmul_kernel.launch_plan(4, 8, 32, 16, bm=2, bn=4)
    assert (plan.bm, plan.bn) == (2, 4)


@pytest.mark.parametrize("pins,host,n,want", [
    (dict(bm=3), False, 16, None),              # 2 rows, the rest planned
    (dict(bm=64, bn=64), False, 16, "legal"),   # cut to 256 threads
    (dict(bm=1, bn=1, tb=1), False, 16, (1, 1, 32)),  # a whole warp
    (dict(bm=1, bn=1, tb=256), True, 32, "legal"),  # K2's stage
    (dict(bm=8, bn=8), False, 16, "legal"),
])
def test_a_pin_is_taken_at_a_power_of_two_and_cut_until_legal(pins, host, n,
                                                               want):
    plan = matmul_kernel.launch_plan(64, 2048, 2048, n, host=host, **pins)
    assert matmul_kernel.fits(n, host, False, plan.bm, plan.bn, plan.tb)
    if want is None:
        free = matmul_kernel.launch_plan(64, 2048, 2048, n)
        assert (plan.bm, plan.bn, plan.tb) == (2, free.bn, free.tb)
    elif want != "legal":
        assert (plan.bm, plan.bn, plan.tb) == want
    assert plan.grid_x == -(-2048 // plan.bn)
    assert plan.grid_y == -(-64 // plan.bm)


# --------------------------------------------------------------- tune

def test_tune_writes_a_card_named_measured_entry(tmp_path):
    path = str(tmp_path / "t.json")
    cache = tuning.TuningCache(path)
    trace = []
    best = tuning.tune(8, 8, 40, 16, cache, cap=4, device="cpu", trace=trace)
    data = json.loads(open(path).read())
    assert data["card"]["name"] == "cpu"
    entry = data["entries"][tuning.bucket_key(8, 8, 40, 16)]
    assert entry["source"] == "measured" and entry["us"] > 0
    assert tuning.Tiling(entry["k_tile"], entry["block_m"], entry["block_n"],
                         entry["tb"]) == best
    assert [c for c, _, _ in trace] == tuning._candidates(8, 8, 40, 16)
    first = trace[0][2]
    for _, ms, out in trace:         # the plain version ignores plans
        assert ms > 0 and torch.equal(out, first)
    fresh = tuning.TuningCache(path)
    assert fresh.lookup(8, 8, 40, 16) == best
    assert (fresh.hits, fresh.misses) == (1, 0)
    with pytest.raises(ValueError, match="into a cache of"):
        tuning.tune(8, 8, 40, 16, tuning.TuningCache(path, card="other"),
                    cap=4, device="cpu")
