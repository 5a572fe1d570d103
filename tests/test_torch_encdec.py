"""The port's enc-dec and VLM families against the JAX reference on the
same weights: Llama-3.2-Vision-11B (4 self-attention layers and a
cross-attention layer a group, patch embeddings as the memory) and
SeamlessM4T-medium (a non-causal encoder over frame embeddings, `xdec`
decoder layers) at `smoke_config`, through `forward` (logits and the
memory prefill returns), `lm_loss`, prefill and decode with that
memory; the reference's own decode-matches-forward consistency
on the port; `param_count` of the full configs; the serve CLI refusing
both families.

Frontend embeddings are N(0, 1) from a numpy seed, as
`tests/test_archs.py::_batch` draws them, and both packages get the same
ones. Tolerances, relative to the largest |logit| (or |memory|): 1e-3 at
f32 compute, 3e-2 at bf16. olm16 runs at f32 on one pattern group and one
row of 4 tokens (both packages' olm GEMMs are slow on the CPU; the
reference's run its TPU kernel in interpret mode); the rest at 2 rows of
8. `lm_loss` under native at f32 within 1e-5 relative, elsewhere within
twice the largest logit difference of the same forward.
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

ARCHS = ("llama_3_2_vision_11b", "seamless_m4t_medium")
FRONTEND = {"llama_3_2_vision_11b": "patches",
            "seamless_m4t_medium": "frames"}
GROUP = {"llama_3_2_vision_11b": 5, "seamless_m4t_medium": 1}
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
CASES = ([(a, "native", dt) for a in ARCHS for dt in ("float32", "bfloat16")]
         + [(a, "olm16", "float32") for a in ARCHS])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(cfg, b, s, seed=0):
    """tokens (b, s) and the family's frontend embeddings, from a seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           FRONTEND[ARCH_OF[cfg.name]]: rng.standard_normal(
               (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    return out


ARCH_OF = {get_config(a).name: a for a in ARCHS}


def pair(arch, mode, dt):
    """(reference model, its params, port model, port params) for the
    smoke config of `arch`; olm16 on one pattern group."""
    over = dict(compute_dtype=dt)
    if mode == "olm16":
        over["n_layers"] = GROUP[arch]
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jm = JModel(jcfg, JEngine(mode=mode, use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def jax_run(jm, b, s):
    """forward logits, lm_loss, prefill logits of the first s-1 tokens with
    the memory it returns, and the decode logits of the last token with
    that memory."""
    jm, jp = jm
    bt = {k: jnp.asarray(v) for k, v in batch(jm.cfg, b, s).items()}
    lg, _ = jm.forward(jp, bt)
    loss, _ = jax_lm_loss(jm, jp, bt)
    pf = {**bt, "tokens": bt["tokens"][:, :s - 1]}
    pl, cache, mem = jm.prefill(jp, pf, jm.init_cache(b, s + 2))
    dl, _ = jm.decode_step(jp, bt["tokens"][:, s - 1],
                           jnp.full((b,), s - 1, jnp.int32), cache, mem)
    return [np.asarray(a, np.float32) for a in (lg, loss, pl, mem, dl)]


def port_run(tm, tp, b, s):
    bt = {k: torch.from_numpy(v) for k, v in batch(tm.cfg, b, s).items()}
    lg, aux = tm.forward(tp, bt)
    assert float(aux) == 0.0
    loss, parts = lm_loss(tm, tp, bt)
    assert torch.isfinite(parts["ppl_proxy"])
    pf = {**bt, "tokens": bt["tokens"][:, :s - 1]}
    pl, cache, mem = tm.prefill(tp, pf, tm.init_cache(b, s + 2))
    dl, _ = tm.decode_step(tp, bt["tokens"][:, s - 1],
                           torch.full((b,), s - 1, dtype=torch.int64), cache,
                           mem)
    return [a.detach().to(torch.float32).numpy()
            for a in (lg, loss, pl, mem, dl)]


@pytest.fixture(scope="module", params=CASES, ids="-".join)
def runs(request):
    arch, mode, dt = request.param
    jm, jp, tm, tp = pair(arch, mode, dt)
    b, s = (1, 4) if mode == "olm16" else (2, 8)
    return request.param, jax_run((jm, jp), b, s), port_run(tm, tp, b, s)


def rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


def test_forward_logits_match_reference(runs):
    (arch, mode, dt), (want, *_), (got, *_) = runs
    assert got.shape == want.shape == (len(got), got.shape[1], 512)
    assert np.isfinite(got).all()
    assert rel(want, got) <= TOL[dt]


def test_memory_matches_reference(runs):
    (arch, mode, dt), (*_, want, _), (*_, got, _) = runs
    cfg = smoke_config(arch)
    assert got.shape == want.shape == (len(got), cfg.n_frontend_tokens,
                                       cfg.d_model)
    if cfg.family == "vlm":            # the patches, cast to compute dtype
        np.testing.assert_array_equal(got, want)
    else:                              # through the non-causal encoder
        assert rel(want, got) <= TOL[dt]


def test_lm_loss_matches_reference(runs):
    (arch, mode, dt), (lw, want, *_), (lg, got, *_) = runs
    assert np.isfinite(got)
    if (mode, dt) == ("native", "float32"):
        assert abs(got - want) <= 1e-5 * abs(want)
    else:
        assert abs(got - want) <= 2 * float(np.abs(lw - lg).max())


def test_prefill_and_decode_with_memory_match_reference(runs):
    (arch, mode, dt), (*_, pw, _, dw), (*_, pg, _, dg) = runs
    assert pg.shape == pw.shape == dg.shape == dw.shape == (len(pg), 512)
    assert rel(pw, pg) <= TOL[dt]
    assert rel(dw, dg) <= TOL[dt]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    # the reference's tests/test_archs.py consistency, on the port alone
    cfg = smoke_config(arch)
    m = Model(cfg, device="cpu")
    params = m.init(seed=1)
    bt = {k: torch.from_numpy(v) for k, v in batch(cfg, 2, 12, 3).items()}
    logits, _ = m.forward(params, bt)
    cache = m.init_cache(2, max_len=16)
    pf = {**bt, "tokens": bt["tokens"][:, :11]}
    lg_p, cache, memory = m.prefill(params, pf, cache)
    lg_d, _ = m.decode_step(params, bt["tokens"][:, 11],
                            torch.full((2,), 11), cache, memory)
    scale = float(logits.abs().max())
    assert float((lg_p - logits[:, 10]).abs().max()) / scale < 2e-2
    assert float((lg_d - logits[:, 11]).abs().max()) / scale < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    # the full published configs: shape arithmetic, nothing allocated
    assert get_config(arch).param_count() == \
        jax_get_config(arch).param_count()


def test_configs_and_layer_kinds_are_the_references():
    for arch in ARCHS:
        cfg, ref = get_config(arch), jax_get_config(arch)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert arch in list_archs()
    vision = get_config("llama_3_2_vision_11b")
    assert vision.layer_kinds.count("cross") == 8
    assert vision.layer_kinds[:5] == ("attn",) * 4 + ("cross",)
    seamless = smoke_config("seamless_m4t_medium")
    assert (seamless.n_enc_layers, seamless.n_frontend_tokens) == (2, 16)


def test_cross_layers_hold_no_cache_and_self_attention_does():
    cfg = smoke_config("llama_3_2_vision_11b")
    caches = Model(cfg, device="cpu").init_cache(2, 16)
    kinds = cfg.layer_kinds
    assert [c is None for c in caches] == [k == "cross" for k in kinds]
    cfg = smoke_config("seamless_m4t_medium")
    caches = Model(cfg, device="cpu").init_cache(2, 16, paged={
        "num_blocks": 5, "block_size": 8})
    assert all("kpool" in c for c in caches)


@pytest.mark.parametrize("arch", ARCHS + ("llama-3.2-vision-11b",
                                          "seamless-m4t-medium"))
def test_serve_cli_refuses_the_family(arch):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="decoder-only"):
        main(["--arch", arch, "--smoke", "--device", "cpu"])
