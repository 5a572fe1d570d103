"""The port's attention pieces against the JAX reference's, on the same
inputs made from numpy seeds: full and half RoPE, the QKV bias, the plain
and the flash (online-softmax) paths with and without a sliding window
and with empty cache slots, the GELU MLP, and the sliding-window ring
caches (a prefill shorter than, as long as and longer than the ring, then
decode steps), held logit for logit and slot for slot.

Tolerances: 1e-6 absolute on f32 elementwise math (RoPE), 2e-5 on f32
attention (the reference's own flash-vs-plain tolerance), one bf16 step
(2^-7 relative to the largest output) at bf16; model logits as in
test_torch_model.py (1e-3 of the largest |logit| at f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models import layers as jl
from repro.models.model import Model as JModel
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models import layers as tl
from repro_torch.models.model import Model

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WINDOW = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(a, dt="float32"):
    """One numpy array as a (jax, torch) pair of dtype dt."""
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["full", "half"])
@pytest.mark.parametrize("per_lane", [False, True])
def test_rope_matches_reference(style, dt, per_lane):
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 5, 3, 32
    jx, tx = both(rng.standard_normal((B, S, H, D)).astype(np.float32), dt)
    pos = (rng.integers(0, 500, (B, S)) if per_lane
           else np.arange(7, 7 + S)).astype(np.int32)
    want = jl.apply_rope(jx, jnp.asarray(pos), style=style, theta=10_000.0)
    got = tl.apply_rope(tx, torch.from_numpy(pos), style=style,
                        theta=10_000.0)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dt == "float32" else 2 ** -7 * float(np.abs(as_np(want)).max())
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=tol)
    if style == "half":          # the second half passes through untouched
        assert torch.equal(got[..., D // 2:], tx[..., D // 2:])


def test_half_rope_frequencies_run_over_the_rotated_width():
    # the pair (0, 1) turns at the same rate in both styles, the last
    # rotated pair of the half style at the rate of pair Dh/2 - 2 of the
    # full style: 1 / theta^((rot - 2) / rot) with rot = Dh / 2
    D = 8
    x = torch.zeros((1, 1, 1, D))
    x[..., D // 2 - 2] = 1.0
    pos = torch.tensor([3])
    got = tl.apply_rope(x, pos, style="half", theta=100.0)
    ang = 3.0 / 100.0 ** ((D // 2 - 2) / (D // 2))
    want = torch.tensor([np.cos(ang), np.sin(ang)], dtype=torch.float32)
    torch.testing.assert_close(got[0, 0, 0, D // 2 - 2:D // 2], want)


def _attn_inputs(rng, B, S, T, H, D):
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v


FLASH_CASES = [  # (causal, window, empty kv slots, per-lane kpos)
    (True, None, False, False), (True, WINDOW, False, False),
    (False, None, False, False), (True, None, True, False),
    (True, WINDOW, True, True)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,empty,per_lane", FLASH_CASES)
def test_flash_matches_reference_flash_and_plain(causal, window, empty,
                                                 per_lane, dt):
    rng = np.random.default_rng(1)
    B, S, T, H, D = 2, 24, 40, 3, 16
    q, k, v = _attn_inputs(rng, B, S, T, H, D)
    qpos = np.broadcast_to(np.arange(T - S, T)[None], (B, S)).astype(np.int32)
    kpos = np.arange(T, dtype=np.int32)
    if empty:                    # slots 30.. empty: whole chunks masked
        kpos = np.where(kpos < 30, kpos, -1).astype(np.int32)
        qpos = np.broadcast_to(np.arange(6, 6 + S)[None], (B, S)).astype(
            np.int32)
    if per_lane:
        kpos = np.stack([kpos, np.roll(kpos, 5)])
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dt) for a in (q, k, v))
    jqp, tqp = jnp.asarray(qpos), torch.from_numpy(np.ascontiguousarray(qpos))
    jkp, tkp = jnp.asarray(kpos), torch.from_numpy(np.ascontiguousarray(kpos))
    kw = dict(causal=causal, window=window)
    want = jl._attn_flash(jq, jk, jv, jqp, jkp, chunk=8, **kw)
    got = tl._attn_flash(tq, tk, tv, tqp, tkp, chunk=8, **kw)
    plain = tl._attn_plain(tq, tk, tv, tqp, tkp, **kw)
    assert got.dtype == tv.dtype and got.shape == (B, S, H, D)
    assert bool(torch.isfinite(got).all())
    scale = float(np.abs(as_np(want)).max())
    tol = 2e-5 if dt == "float32" else 2 ** -7 * scale
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=tol)
    # flash against plain: the reference's 2e-5 at f32; at bf16 the two
    # round the probabilities at different points, a few bf16 steps
    tol = 2e-5 if dt == "float32" else 4 * 2 ** -7 * scale
    np.testing.assert_allclose(as_np(got), as_np(plain), rtol=0, atol=tol)


def test_attn_core_switches_to_flash_where_the_reference_does(monkeypatch):
    assert tl.FLASH_MIN_ELEMS == jl.FLASH_MIN_ELEMS == 512 * 1024
    calls = []
    real = tl._attn_flash
    monkeypatch.setattr(tl, "_attn_flash",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tl, "FLASH_MIN_ELEMS", 64)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(rng, 1, 8, 8, 4, 8))
    pos = torch.arange(8)
    tl._attn_core(q, k[:, :7, :2], v[:, :7, :2], pos[None], pos[:7],
                  causal=True)
    assert calls == []                             # 8 x 7 < 64
    tl._attn_core(q, k[:, :, :2], v[:, :, :2], pos[None], pos, causal=True)
    assert calls == [1]                            # 8 x 8 >= 64


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_attention_with_bias_and_mlp_match_reference(dt, mlp_type):
    jcfg = dataclasses.replace(jax_smoke_config("chatglm3_6b"),
                               compute_dtype=dt, mlp_type=mlp_type)
    cfg = dataclasses.replace(smoke_config("chatglm3_6b"), compute_dtype=dt,
                              mlp_type=mlp_type)
    key = jax.random.PRNGKey(3)
    jp = {"attn": jl.attention_init(key, jcfg),
          "mlp": jl.mlp_init(key, jcfg)}
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        jp["attn"][name] = jnp.asarray(
            rng.standard_normal(jp["attn"][name].shape), jnp.float32)
    tp = {part: {n: torch.from_numpy(np.array(a)) for n, a in d.items()}
          for part, d in jp.items()}
    assert set(tp["mlp"]) == ({"wg", "wu", "wd"} if mlp_type == "swiglu"
                              else {"wu", "wd"})
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    jx, tx = both(x, dt)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6)).astype(np.int32)
    want, _ = jl.attention_apply(jp["attn"], jcfg, jx, jnp.asarray(pos),
                                 JEngine())
    got, _ = tl.attention_apply(tp["attn"], cfg, tx, torch.from_numpy(pos),
                                DotEngine())
    scale = float(np.abs(as_np(want)).max())
    tol = 1e-5 * scale if dt == "float32" else 2 * 2 ** -7 * scale
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=tol)
    want = jl.mlp_apply(jp["mlp"], jcfg, jx, JEngine())
    got = tl.mlp_apply(tp["mlp"], cfg, tx, DotEngine())
    scale = float(np.abs(as_np(want)).max())
    tol = 1e-5 * scale if dt == "float32" else 2 * 2 ** -7 * scale
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0, atol=tol)


def _swa_pair(arch="chatglm3_6b"):
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32",
                               sliding_window=WINDOW)
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              sliding_window=WINDOW)
    jm = JModel(jcfg, JEngine())
    jp = jm.init(jax.random.PRNGKey(4))
    tm = Model(cfg, DotEngine(), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


@pytest.mark.parametrize("S", [10, WINDOW, 23, 40])
def test_ring_cache_prefill_and_decode_match_reference(S):
    # prefill S tokens into a ring of WINDOW slots (S < T, S == T, S > T,
    # S > 2T), then decode 5 steps: logits and the ring's slots as the
    # reference's, lanes at different depths
    jm, jp, tm, tp = _swa_pair()
    rng = np.random.default_rng(S)
    B, max_len = 2, 64
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, max_len)
    tc = tm.init_cache(B, max_len)
    assert tc[0]["k"].shape[1] == WINDOW
    lw, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lg, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert _rel(np.asarray(lw), lg.numpy()) <= 1e-3
    pos = np.asarray([S, S - 3], np.int32)       # lane 1 rewrites 3 slots
    for step in range(5):
        nxt = rng.integers(0, 512, (B,)).astype(np.int32)
        lw, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        lg, tc = tm.decode_step(tp, torch.from_numpy(nxt),
                                torch.from_numpy(pos.astype(np.int64)), tc)
        assert _rel(np.asarray(lw), lg.numpy()) <= 1e-3, step
        pos = pos + 1
    jk = np.asarray(jc["scan"][0]["k"])               # (G, B, T, H, D)
    for layer in range(tm.cfg.n_layers):
        np.testing.assert_allclose(tc[layer]["k"].numpy(), jk[layer],
                                   rtol=0, atol=1e-5)


def test_window_longer_than_max_len_is_a_plain_contiguous_cache():
    # T = min(max_len, window): with max_len < window there is no ring
    jm, jp, tm, tp = _swa_pair("yi_34b")
    toks = np.random.default_rng(5).integers(0, 512, (2, 6)).astype(np.int32)
    jc, tc = jm.init_cache(2, 12), tm.init_cache(2, 12)
    assert tc[0]["k"].shape[1] == 12
    lw, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    lg, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    pos = np.asarray([6, 6], np.int32)
    lw, _ = jm.decode_step(jp, jnp.asarray([1, 2]), jnp.asarray(pos), jc)
    lg, _ = tm.decode_step(tp, torch.tensor([1, 2]), torch.tensor([6, 6]), tc)
    assert _rel(np.asarray(lw), lg.numpy()) <= 1e-3


def test_window_layers_stay_contiguous_under_the_paged_layout():
    _, _, tm, _ = _swa_pair()
    cache = tm.init_cache(2, 64, paged={"num_blocks": 9, "block_size": 8})
    assert all(set(c) == {"k", "v"} and c["k"].shape[1] == WINDOW
               for c in cache)
    plain = Model(dataclasses.replace(tm.cfg, sliding_window=None),
                  device="cpu")
    cache = plain.init_cache(2, 64, paged={"num_blocks": 9, "block_size": 8})
    assert all(c["table"] is cache[0]["table"] for c in cache)


def test_chunked_call_on_a_ring_raises_as_in_the_reference():
    jm, jp, tm, tp = _swa_pair()
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="sliding-window ring"):
        jm.prefill_chunk(jp, {"tokens": jnp.asarray(toks)},
                         jm.init_cache(1, 32), 0)
    with pytest.raises(ValueError, match="sliding-window ring"):
        tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks)},
                         tm.init_cache(1, 32), 0)
