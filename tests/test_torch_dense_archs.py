"""The port's dense family against the JAX reference on the same weights:
every dense arch of the port at `smoke_config` (ChatGLM3-6B's QKV bias and
half RoPE, Qwen1.5-110B's bias, Yi-34B and InternLM2-1.8B), through
`forward`, `lm_loss`, prefill and decode; the reference's own
decode-matches-forward consistency on the port; `param_count` of the full
configs; tied embeddings.

The reference initializes its attention biases to zeros, so every case
first writes seeded non-zero `bq`/`bk`/`bv` into the reference tree, and
the port runs on `params_from_jax` of that tree.

Tolerances, relative to the largest |logit| (as in test_torch_model.py):
1e-3 at f32 compute, 3e-2 at bf16. `lm_loss` under native at f32 within
1e-5 relative; elsewhere within twice the largest logit difference of
the same forward, the most a masked mean of logsumexp minus the gold
logit can move.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models.model import Model as JModel
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models.model import Model, lm_loss

ARCHS = ("chatglm3_6b", "yi_34b", "qwen1_5_110b", "internlm2_1_8b")
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
B, S = 2, 8
CASES = ([(a, "native", dt) for a in ARCHS for dt in ("float32", "bfloat16")]
         + [("chatglm3_6b", "olm16", dt) for dt in ("float32", "bfloat16")])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_biases(tree, seed=7):
    """The reference tree with seeded non-zero attention biases (its init
    leaves them zero)."""
    rng = np.random.default_rng(seed)
    for slot in tree["blocks"]["scan"]:
        attn = slot["attn"]
        for key in ("bq", "bk", "bv"):
            if key in attn:
                attn[key] = jnp.asarray(
                    0.5 * rng.standard_normal(attn[key].shape),
                    attn[key].dtype)
    return tree


def pair(arch, mode, dt, **over):
    """(reference model, its params, port model, port params) for the
    smoke config of `arch`, the biases non-zero."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=dt,
                               **over)
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype=dt, **over)
    # the reference's olm GEMMs run its TPU kernel in interpret mode
    jm = JModel(jcfg, JEngine(mode=mode, use_pallas=True))
    jp = with_biases(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def jax_run(jm, jp):
    """forward logits, lm_loss, prefill logits of the first S-1 tokens and
    the decode logits of the last one."""
    toks = jnp.asarray(tokens())
    lg, _ = jm.forward(jp, {"tokens": toks})
    loss, _ = jax_lm_loss(jm, jp, {"tokens": toks})
    pl, cache, _ = jm.prefill(jp, {"tokens": toks[:, :S - 1]},
                              jm.init_cache(B, S + 2))
    dl, _ = jm.decode_step(jp, toks[:, S - 1],
                           jnp.full((B,), S - 1, jnp.int32), cache)
    return [np.asarray(a, np.float32) for a in (lg, loss, pl, dl)]


def port_run(tm, tp):
    toks = torch.from_numpy(tokens())
    lg, aux = tm.forward(tp, {"tokens": toks})
    assert aux.dtype == torch.float32 and aux.ndim == 0 and float(aux) == 0.0
    loss, parts = lm_loss(tm, tp, {"tokens": toks})
    assert torch.isfinite(parts["ppl_proxy"])
    pl, cache, _ = tm.prefill(tp, {"tokens": toks[:, :S - 1]},
                              tm.init_cache(B, S + 2))
    dl, _ = tm.decode_step(tp, toks[:, S - 1],
                           torch.full((B,), S - 1, dtype=torch.int64), cache)
    return [a.detach().numpy() for a in (lg, loss, pl, dl)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "-".join(c))
def runs(request):
    arch, mode, dt = request.param
    jm, jp, tm, tp = pair(arch, mode, dt)
    return request.param, jax_run(jm, jp), port_run(tm, tp)


def rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


def test_forward_logits_match_reference(runs):
    (arch, mode, dt), (want, *_), (got, *_) = runs
    assert got.shape == want.shape == (B, S, 512)
    assert rel(want, got) <= TOL[dt]


def test_lm_loss_matches_reference(runs):
    (arch, mode, dt), (lw, want, *_), (lg, got, *_) = runs
    assert np.isfinite(got)
    if (mode, dt) == ("native", "float32"):
        assert abs(got - want) <= 1e-5 * abs(want)
    else:
        assert abs(got - want) <= 2 * float(np.abs(lw - lg).max())


def test_prefill_and_decode_logits_match_reference(runs):
    (arch, mode, dt), (_, _, pw, dw), (_, _, pg, dg) = runs
    assert pg.shape == pw.shape == dg.shape == dw.shape == (B, 512)
    assert rel(pw, pg) <= TOL[dt]
    assert rel(dw, dg) <= TOL[dt]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    # the reference's tests/test_archs.py consistency, on the port alone
    cfg = smoke_config(arch)
    m = Model(cfg, device="cpu")
    params = m.init(seed=1)
    attn = params["layers"][0]["attn"]
    if cfg.qkv_bias:            # exercise the biases on the port's own init
        g = torch.Generator().manual_seed(2)
        for layer in params["layers"]:
            for key in ("bq", "bk", "bv"):
                b = layer["attn"][key]
                b.copy_(0.5 * torch.randn(b.shape, generator=g))
        assert bool((attn["bq"] != 0).any())
    toks = torch.from_numpy(tokens(seed=3, shape=(2, 12)))
    logits, _ = m.forward(params, {"tokens": toks})
    cache = m.init_cache(2, max_len=16)
    lg_p, cache, _ = m.prefill(params, {"tokens": toks[:, :11]}, cache)
    lg_d, _ = m.decode_step(params, toks[:, 11], torch.full((2,), 11), cache)
    scale = float(logits.abs().max())
    assert float((lg_p - logits[:, 10]).abs().max()) / scale < 2e-2
    assert float((lg_d - logits[:, 11]).abs().max()) / scale < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    # the full published configs: shape arithmetic, nothing allocated
    assert get_config(arch).param_count() == \
        jax_get_config(arch).param_count()
    tied = dataclasses.replace(get_config(arch), tie_embeddings=True)
    assert tied.param_count() == dataclasses.replace(
        jax_get_config(arch), tie_embeddings=True).param_count()


def test_registry_names_the_dense_archs_and_aliases():
    assert set(list_archs()) == set(ARCHS) | {
        "recurrentgemma_9b", "mamba2_130m", "mixtral_8x22b",
        "qwen3_moe_235b_a22b", "llama_3_2_vision_11b", "seamless_m4t_medium"}
    assert {a for a in list_archs()
            if get_config(a).family == "dense"} == set(ARCHS)
    for alias, arch in (("chatglm3-6b", "chatglm3_6b"), ("yi-34b", "yi_34b"),
                        ("qwen1.5-110b", "qwen1_5_110b")):
        assert get_config(alias) == get_config(arch)
    cfg = get_config("chatglm3_6b")
    assert (cfg.qkv_bias, cfg.rope_style, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (True, "half", 2, 13696, 65024)
    assert get_config("qwen1_5_110b").qkv_bias


def test_tied_embeddings_match_reference():
    jm, jp, tm, tp = pair("qwen1_5_110b", "native", "float32",
                          tie_embeddings=True)
    assert "unembed" not in tp and "unembed" not in jp
    want, loss_w, pw, dw = jax_run(jm, jp)
    got, loss_g, pg, dg = port_run(tm, tp)
    assert rel(want, got) <= TOL["float32"]
    assert rel(pw, pg) <= TOL["float32"] and rel(dw, dg) <= TOL["float32"]
    assert abs(loss_g - loss_w) <= 1e-5 * abs(loss_w)
    # a tied model's own init holds no head table; the head reads embed
    own = tm.init(seed=0)
    assert "unembed" not in own
    lg, _ = tm.forward(own, {"tokens": torch.from_numpy(tokens())})
    lg2, _ = tm.forward({**own, "unembed": own["embed"]},
                        {"tokens": torch.from_numpy(tokens())})
    assert torch.equal(lg, lg2)


def test_lm_loss_mask_and_aux_weight():
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"),
                              compute_dtype="float32")
    m = Model(cfg, device="cpu")
    params = m.init(seed=0)
    toks = torch.from_numpy(tokens())
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[:, S // 2:] = 0
    total, parts = lm_loss(m, params, {"tokens": toks, "mask": mask})
    logits, _ = m.forward(params, {"tokens": toks})
    lp = torch.log_softmax(logits[:, :-1].double(), dim=-1)
    nll = -lp.gather(-1, toks[:, 1:, None].long())[..., 0]
    want = float((nll * mask[:, 1:]).sum() / mask[:, 1:].sum())
    assert abs(float(parts["loss"]) - want) <= 1e-5 * want
    assert float(total) == float(parts["loss"])      # the aux is zero
    torch.testing.assert_close(parts["ppl_proxy"], torch.exp(parts["loss"]))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "yi_34b", "qwen1.5-110b"])
def test_serve_cli_serves_each_arch_at_smoke_size(arch, capsys):
    from repro_torch.launch.serve import main
    rep = main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--max-new", "3", "--max-len", "32"])
    assert rep["n"] == 2 and rep["new_tokens"] == 6
    assert '"finish_reasons": {"length": 2}' in capsys.readouterr().out
