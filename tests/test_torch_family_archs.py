"""The port's recurrent and MoE families against the JAX reference on the
same weights: RecurrentGemma-9B (RG-LRU and windowed MQA, 2 pattern
groups, a 5-layer variant whose remainder runs the `rec, rec` tail, and
one group of 3 layers under olm16),
Mamba2-130M (SSD, tied head), Mixtral-8x22B (8 experts, window) and
Qwen3-MoE-235B-A22B at `smoke_config`, through `forward` (logits and the
aux loss), `lm_loss`, prefill and decode; the reference's own
decode-matches-forward consistency on the port; `param_count` of the
full configs; the serve CLI on each arch.

The reference initializes the RG-LRU gate biases and the SSD dt bias to
zeros, so every case first writes seeded non-zero ones into its tree, and
the port runs on `params_from_jax` of that tree.

Tolerances, relative to the largest |logit|: 1e-3 at f32 compute, 3e-2
at bf16. `lm_loss` and aux under native at f32 within 1e-5 relative;
elsewhere `lm_loss` within twice the largest logit difference of the
same forward, and aux within 3e-2 relative.
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

ARCHS = ("recurrentgemma_9b", "mamba2_130m", "mixtral_8x22b",
         "qwen3_moe_235b_a22b")
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
B, S = 2, 8
# olm16 at f32 only: at bf16 the compiled reference disagrees with its
# own op-by-op run (jax.disable_jit) by up to 3.2e-2 of the largest
# |logit| on this model (XLA's fused f32 accumulation order flips bf16
# roundings, which the recurrences carry), while the port equals the
# op-by-op run bit for bit; that run of the olm16 reference takes minutes.
# olm16 runs one pattern group (rec, rec, attn) on one row: both
# packages' olm GEMMs are slow on the CPU.
CASES = ([(a, "native", dt, None) for a in ARCHS
          for dt in ("float32", "bfloat16")]
         + [("recurrentgemma_9b", "olm16", "float32", 3),
            ("recurrentgemma_9b", "native", "float32", 5)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_biases(tree, seed=7):
    """The reference tree with seeded non-zero RG-LRU gate biases and SSD
    dt biases (its init leaves them zero)."""
    rng = np.random.default_rng(seed)
    slots = list(tree["blocks"]["scan"]) + list(tree["blocks"]["rem"])
    for slot in slots:
        for mixer, keys in (("rec", ("ba", "bi")), ("ssm", ("dt_bias",))):
            for key in keys if mixer in slot else ():
                leaf = slot[mixer][key]
                slot[mixer][key] = jnp.asarray(
                    0.5 * rng.standard_normal(leaf.shape), leaf.dtype)
    return tree


def pair(arch, mode, dt, n_layers=None):
    """(reference model, its params, port model, port params) for the
    smoke config of `arch`, the biases non-zero."""
    over = dict(compute_dtype=dt)
    if n_layers is not None:
        over["n_layers"] = n_layers
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    # the reference's olm GEMMs run its TPU kernel in interpret mode
    jm = JModel(jcfg, JEngine(mode=mode, use_pallas=True))
    jp = with_biases(jm.init(jax.random.PRNGKey(0)))
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def jax_run(jm, jp, b=B):
    """forward logits and aux, lm_loss, prefill logits of the first S-1
    tokens and the decode logits of the last one, for b rows."""
    toks = jnp.asarray(tokens()[:b])
    lg, aux = jm.forward(jp, {"tokens": toks})
    loss, _ = jax_lm_loss(jm, jp, {"tokens": toks})
    pl, cache, _ = jm.prefill(jp, {"tokens": toks[:, :S - 1]},
                              jm.init_cache(b, S + 2))
    dl, _ = jm.decode_step(jp, toks[:, S - 1],
                           jnp.full((b,), S - 1, jnp.int32), cache)
    return [np.asarray(a, np.float32) for a in (lg, aux, loss, pl, dl)]


def port_run(tm, tp, b=B):
    toks = torch.from_numpy(tokens()[:b])
    lg, aux = tm.forward(tp, {"tokens": toks})
    assert aux.dtype == torch.float32 and aux.ndim == 0
    loss, parts = lm_loss(tm, tp, {"tokens": toks})
    assert torch.isfinite(parts["ppl_proxy"])
    pl, cache, _ = tm.prefill(tp, {"tokens": toks[:, :S - 1]},
                              tm.init_cache(b, S + 2))
    dl, _ = tm.decode_step(tp, toks[:, S - 1],
                           torch.full((b,), S - 1, dtype=torch.int64), cache)
    return [a.detach().numpy() for a in (lg, aux, loss, pl, dl)]


def _id(case):
    arch, mode, dt, n = case
    return "-".join([arch, mode, dt] + ([f"{n}layers"] if n else []))


@pytest.fixture(scope="module", params=CASES, ids=_id)
def runs(request):
    jm, jp, tm, tp = pair(*request.param)
    b = 1 if request.param[1] == "olm16" else B
    return request.param, jax_run(jm, jp, b), port_run(tm, tp, b)


def rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


def test_forward_logits_match_reference(runs):
    (arch, mode, dt, _), (want, *_), (got, *_) = runs
    assert got.shape == want.shape == (len(got), S, 512)
    assert rel(want, got) <= TOL[dt]


def test_aux_loss_matches_reference(runs):
    (arch, mode, dt, _), (_, want, *_), (_, got, *_) = runs
    if not smoke_config(arch).n_experts:
        assert want == got == 0.0
        return
    assert np.isfinite(got) and got > 0
    tol = 1e-5 if (mode, dt) == ("native", "float32") else 3e-2
    assert abs(got - want) <= tol * abs(want)


def test_lm_loss_matches_reference(runs):
    (arch, mode, dt, _), (lw, _, want, *_), (lg, _, got, *_) = runs
    assert np.isfinite(got)
    if (mode, dt) == ("native", "float32"):
        assert abs(got - want) <= 1e-5 * abs(want)
    else:
        assert abs(got - want) <= 2 * float(np.abs(lw - lg).max()) \
            + 0.01 * 3e-2 * abs(float(runs[1][1]))    # aux_weight * its tol


def test_prefill_and_decode_logits_match_reference(runs):
    (arch, mode, dt, _), (*_, pw, dw), (*_, pg, dg) = runs
    assert pg.shape == pw.shape == dg.shape == dw.shape == (len(pg), 512)
    assert rel(pw, pg) <= TOL[dt]
    assert rel(dw, dg) <= TOL[dt]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    # the reference's tests/test_archs.py consistency, on the port alone
    cfg = smoke_config(arch)
    m = Model(cfg, device="cpu")
    params = m.init(seed=1)
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


def test_layer_kinds_run_in_the_references_order():
    cfg = get_config("recurrentgemma_9b")
    kinds = cfg.layer_kinds
    assert len(kinds) == 38 and kinds[-2:] == ("rec", "rec")
    assert kinds.count("attn") == 12 and kinds.count("rec") == 26
    assert kinds[:3] == ("rec", "rec", "attn")
    five = dataclasses.replace(smoke_config("recurrentgemma_9b"), n_layers=5)
    assert five.layer_kinds == ("rec", "rec", "attn", "rec", "rec")
    assert get_config("mamba2_130m").layer_kinds == ("ssm",) * 24


def test_f32_leaves_keep_their_dtype_under_bf16_params():
    jm, jp, tm, tp = pair("recurrentgemma_9b", "native", "float32")
    cfg = dataclasses.replace(smoke_config("recurrentgemma_9b"),
                              param_dtype="bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rec = tp["layers"][0]["rec"]
    assert rec["lam"].dtype == torch.float32
    assert rec["wx"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        rec["lam"].numpy(), np.asarray(jp["blocks"]["scan"][0]["rec"]["lam"][0]))


def test_config_admits_the_ported_families_and_refuses_the_rest():
    # every family and block kind of the reference is ported (the enc-dec
    # and VLM ones since the cross-attention slice); others are refused
    base = smoke_config("internlm2_1_8b")
    for family in ("encdec", "vlm"):
        assert dataclasses.replace(base, family=family).family == family
    for kind in ("cross", "xdec"):
        assert dataclasses.replace(base, block_pattern=("attn", kind))
    with pytest.raises(ValueError, match="not ported"):
        dataclasses.replace(base, family="diffusion")
    with pytest.raises(ValueError, match="not ported"):
        dataclasses.replace(base, block_pattern=("attn", "conv"))
    with pytest.raises(ValueError, match="n_experts"):
        dataclasses.replace(base, family="moe")
    assert {get_config(a).family for a in ARCHS} == {"hybrid", "ssm", "moe"}
    assert set(ARCHS) <= set(list_archs())


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b", "mamba2-130m"))
def test_serve_cli_serves_each_arch_at_smoke_size(arch, capsys):
    from repro_torch.launch.serve import main
    rep = main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--max-new", "3", "--max-len", "32"])
    assert rep["n"] == 2 and rep["new_tokens"] == 6
    assert '"finish_reasons": {"length": 2}' in capsys.readouterr().out
