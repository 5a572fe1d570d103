"""The port's dense decoder against the JAX reference on the same weights
(`params_from_jax` on `smoke_config("internlm2_1_8b")`), and the port's
paged decode against its contiguous decode.

Tolerances, relative to the largest |logit|:
  * f32 compute, 1e-3: the olm GEMMs are bit-identical given identical
    inputs, but RMSNorm, RoPE and softmax differ between XLA and PyTorch
    by float32 ulps, and an input an ulp away from a rounding boundary
    moves one 2^-16 quantization step of a GEMM operand.
  * bf16 compute, 3e-2: every activation is rounded to bf16 (8 mantissa
    bits, relative step 2^-8 ~ 4e-3) after each layer, and the two
    frameworks round at different points of the same op chains, so a few
    bf16 steps accumulate over the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models.model import Model as JModel
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.models.model import Model

ARCH = "internlm2_1_8b"
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
B, S = 2, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mode, compute_dtype):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype=compute_dtype)
    # The reference's olm GEMMs run its TPU kernel in interpret mode
    # (bit-identical to its broadcast oracle, and quicker to compile).
    jm = JModel(jcfg, JEngine(mode=mode, use_pallas=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, tm, tp


def _tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)


def _jax_logits(jm, jp):
    toks = _tokens()
    lg, cache, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(B, S + 2))
    lg2, _ = jm.decode_step(jp, jnp.asarray([3, 4]), jnp.asarray([S, S]), cache)
    return np.asarray(lg, np.float32), np.asarray(lg2, np.float32)


def _port_logits(tm, tp, paged=None):
    toks = torch.from_numpy(_tokens())
    cache = tm.init_cache(B, S + 2)
    lg, cache, _ = tm.prefill(tp, {"tokens": toks}, cache)
    if paged is not None:
        # the same decode through a block pool: lanes own blocks 1.. in
        # order, and the contiguous prefill rows are scattered into them
        from repro_torch.models.layers import paged_scatter_rows
        bs = paged
        pcache = tm.init_cache(B, S + 2, paged={"num_blocks": 1 + B * 2,
                                                "block_size": bs})
        table = torch.arange(1, 1 + B * 2, dtype=torch.int32).reshape(B, 2)
        pcache[0]["table"].copy_(table)
        for pc, c in zip(pcache, cache):
            paged_scatter_rows(pc["kpool"], c["k"], table)
            paged_scatter_rows(pc["vpool"], c["v"], table)
        cache = pcache
    lg2, _ = tm.decode_step(tp, torch.tensor([3, 4]), torch.tensor([S, S]), cache)
    return lg.numpy(), lg2.numpy()


@pytest.fixture(scope="module", params=[("native", "float32"),
                                        ("olm16", "float32"),
                                        ("native", "bfloat16"),
                                        ("olm16", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def logits(request):
    mode, dt = request.param
    jm, jp, tm, tp = _pair(mode, dt)
    return dt, _jax_logits(jm, jp), _port_logits(tm, tp)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_prefill_logits_match_reference(logits):
    dt, (want, _), (got, _) = logits
    assert got.shape == want.shape == (B, 512)
    assert _rel(want, got) <= TOL[dt]


def test_decode_logits_match_reference(logits):
    dt, (_, want), (_, got) = logits
    assert got.shape == want.shape == (B, 512)
    assert _rel(want, got) <= TOL[dt]


@pytest.mark.parametrize("mode", ["native", "olm16"])
def test_paged_decode_equals_contiguous(mode):
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = tm.init(seed=1)
    _, contiguous = _port_logits(tm, tp)
    _, paged = _port_logits(tm, tp, paged=4)
    assert np.array_equal(contiguous, paged)


def test_padded_vocab_is_masked():
    cfg = dataclasses.replace(smoke_config(ARCH), vocab_size=500,
                              compute_dtype="float32")
    tm = Model(cfg, device="cpu")
    tp = tm.init(seed=0)
    lg, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(_tokens()) % 500},
                          tm.init_cache(B, S))
    assert lg.shape == (B, 512) and bool((lg[:, 500:] < -1e8).all())


def test_seeded_init_is_deterministic():
    cfg = smoke_config(ARCH)
    a = Model(cfg, device="cpu").init(seed=3)
    b = Model(cfg, device="cpu").init(seed=3)
    assert torch.equal(a["layers"][1]["mlp"]["wd"], b["layers"][1]["mlp"]["wd"])
    assert a["embed"]["table"].shape == (cfg.vocab_padded, cfg.d_model)
