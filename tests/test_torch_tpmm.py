"""The port's truncated digit-plane matmul (tpmm) on the CPU against the JAX
reference: the plane decomposition and its inverse, `kept_levels` and the
cost model (exact), `tpmm` against the reference's engine path `tpmm_ref`
bit for bit and against the TPU kernel `tpmm_pallas` in interpret mode
(atol = rtol = 1e-5: that kernel adds its 128-wide K blocks in float32, a
tiling artefact the reference's own tests allow), the tpmm16 / tpmm8
DotEngine modes with bf16 activations, and the smoke InternLM2 model under
tpmm16 against the JAX model on the same weights. The Hopper kernel's
split of K is checked here as far as the CPU can: its plan covers K and
keeps the int32 guard, and int32 level partials over any K slices, added
in any order and then folded, give `tpmm_ref`'s bits. Inputs are made
from a seed with numpy; float32 results are compared through int32 bit
views."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.kernels.tpmm import ops as jops
from repro.kernels.tpmm import quantize as jq
from repro.kernels.tpmm import ref as jref
from repro.models.model import Model as JModel
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine
from repro_torch.kernels.tpmm import kernel as tkernel
from repro_torch.kernels.tpmm import ops as tops
from repro_torch.kernels.tpmm import quantize as tq
from repro_torch.kernels.tpmm import ref as tref
from repro_torch.models.model import Model

ARCH = "internlm2_1_8b"
SHAPES = [(5, 70, 37), (1, 33, 9), (16, 128, 20)]          # (M, K, N)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    a[0] *= np.float32(2.0 ** -20)                   # a row far below the rest
    if M > 1:
        a[1] = (rng.standard_normal(K) * 1e-40).astype(np.float32)  # subnormal
    return a, b


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("plane_bits,n_bits", [(2, 16), (4, 8), (4, 16),
                                               (6, 24)])
@pytest.mark.parametrize("axis", [0, 1])
def test_plane_decompose_matches_reference(plane_bits, n_bits, axis):
    a, _ = _operands(plane_bits + axis, 6, 40, 1)
    a[2, 3] = 2.0 ** 7                               # a power-of-two maximum
    D = tref.num_planes_for(n_bits, plane_bits)
    jp, js = jq.plane_decompose(jnp.asarray(a), num_planes=D,
                                plane_bits=plane_bits, axis=axis)
    tp, ts = tq.plane_decompose(torch.from_numpy(a), num_planes=D,
                                plane_bits=plane_bits, axis=axis)
    assert tp.dtype == torch.int8 and tp.shape == (D, 6, 40)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(_bits(ts.numpy()), _bits(js))
    # The port weighs plane d by the exact 2^-b(d+1), so its
    # reconstruction is the exact value (b * D <= 24 bits fit float32).
    got = tq.plane_reconstruct(tp, ts, plane_bits=plane_bits).numpy()
    w = np.exp2(-plane_bits * np.arange(1, D + 1, dtype=np.float64))
    exact = (np.tensordot(w, tp.numpy().astype(np.float64), axes=(0, 0))
             * ts.numpy()).astype(np.float32)
    assert np.array_equal(_bits(got), _bits(exact))
    # The reference takes its weights from jnp.exp2, which on this XLA
    # lands an ulp off the exact powers from 2^-16 on (a reference caveat,
    # ROADMAP section 3). Where its weights are exact the two agree bit for
    # bit; elsewhere within that one-ulp weight error.
    want = np.asarray(jq.plane_reconstruct(jp, js, plane_bits=plane_bits))
    jw = np.asarray(jq.plane_reconstruct(jnp.eye(D, dtype=jnp.int8)[:, None],
                                         jnp.ones((1, 1)),
                                         plane_bits=plane_bits))[0]
    if np.array_equal(jw, w.astype(np.float32)):
        assert np.array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)


def test_plane_decompose_promotes_bf16_like_the_reference():
    # bf16 activations: the scale is taken in float32 and a / scale runs in
    # float32, so the planes equal those of the float32-widened input.
    a, _ = _operands(3, 4, 24, 1)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    jp, js = jq.plane_decompose(jnp.asarray(ab.float().numpy(), jnp.bfloat16),
                                num_planes=4, axis=1)
    tp, ts = tq.plane_decompose(ab, num_planes=4, axis=1)
    wp, ws = tq.plane_decompose(ab.float(), num_planes=4, axis=1)
    assert ts.dtype == torch.float32
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(_bits(ts.numpy()), _bits(js))
    assert torch.equal(tp, wp) and torch.equal(ts, ws)


def test_plane_decompose_refuses_what_the_reference_refuses():
    a = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="plane_bits"):
        tq.plane_decompose(a, num_planes=4, plane_bits=8)
    with pytest.raises(ValueError, match="overflows"):
        tq.plane_decompose(a, num_planes=8, plane_bits=4)


def test_kept_levels_and_cost_model_exact():
    for n_bits in (4, 8, 12, 16, 24, 28):
        for plane_bits in (2, 3, 4, 7):
            for mode in ("full", "nbit", "eq8"):
                assert (tref.kept_levels(n_bits, plane_bits, mode=mode)
                        == jref.kept_levels(n_bits, plane_bits, mode=mode))
                assert (tops.tpmm_cost_model(n_bits, plane_bits, mode)
                        == jops.tpmm_cost_model(n_bits, plane_bits, mode))
            assert (tref.num_planes_for(n_bits, plane_bits)
                    == jref.num_planes_for(n_bits, plane_bits))
    with pytest.raises(ValueError, match="unknown tpmm mode"):
        tref.kept_levels(16, 4, mode="half")
    assert tops.tpmm_cost_model(16)["pair_matmuls_truncated"] == 10
    assert tops.tpmm_cost_model(8)["pair_matmuls_truncated"] == 3


@pytest.mark.parametrize("n_bits,mode", [(16, "nbit"), (8, "nbit"),
                                         (16, "full"), (16, "eq8"),
                                         (8, "full")])
def test_tpmm_bit_identical_to_reference_oracle(n_bits, mode):
    for i, (M, K, N) in enumerate(SHAPES):
        a, b = _operands(i, M, K, N)
        want = jops.tpmm(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                         mode=mode, use_pallas=False)
        got = tops.tpmm(torch.from_numpy(a), torch.from_numpy(b),
                        n_bits=n_bits, mode=mode)
        assert got.shape == (M, N)
        assert np.array_equal(_bits(want), _bits(got.numpy())), (M, K, N)


@pytest.mark.parametrize("n_bits", [8, 16])
def test_tpmm_close_to_tpu_kernel_in_interpret_mode(n_bits):
    a, b = _operands(7, 40, 100, 36)
    want = jops.tpmm(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                     use_pallas=True, interpret=True, block_m=32, block_n=32,
                     block_k=32)
    got = tops.tpmm(torch.from_numpy(a), torch.from_numpy(b), n_bits=n_bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_tpmm_plain_version_on_planes_matches_reference():
    a, b = _operands(4, 6, 50, 11)
    D = 4
    jap, jsa = jq.plane_decompose(jnp.asarray(a), num_planes=D, axis=1)
    jbp, jsb = jq.plane_decompose(jnp.asarray(b), num_planes=D, axis=0)
    want = jref.tpmm_ref(jap, jbp, jsa, jsb, n_bits=16)
    got = tref.tpmm_ref(torch.from_numpy(np.array(jap)),
                        torch.from_numpy(np.array(jbp)),
                        torch.from_numpy(np.array(jsa)),
                        torch.from_numpy(np.array(jsb)), n_bits=16)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("mode", ["tpmm16", "tpmm8"])
def test_engine_modes_with_bf16_activations(mode):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 9)) * 0.1).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = JEngine(mode=mode).dot(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(w))
    got = DotEngine(mode=mode).dot(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 9)
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.to(torch.float32).numpy())
    # the LM head's transposed bf16 table goes the same way
    table = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    want = JEngine(mode=mode).dot(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(table.float().numpy(), jnp.bfloat16).T)
    got = DotEngine(mode=mode).dot(xb, table.T)
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.to(torch.float32).numpy())


def test_zero_level_sums_are_positive_zero():
    # K = 1 with a zero row: each level sum is a zero digit times a
    # negative one. The reference sums in int32, whose zero has no sign, so
    # the output is +0; a float64 product would give -0.
    a = np.zeros((2, 1), np.float32)
    a[1, 0] = 1.0
    b = np.array([[-1.0, 2.0, -0.5]], np.float32)
    for n_bits in (8, 16):
        want = jops.tpmm(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                         use_pallas=False)
        got = tops.tpmm(torch.from_numpy(a), torch.from_numpy(b),
                        n_bits=n_bits)
        assert np.array_equal(_bits(want), _bits(got.numpy()))
        assert not np.signbit(got.numpy()[0]).any()


# --- the kernel's split of K --------------------------------------------------

SERVE_SHAPES = [(M, K, N) for M in (4, 64)
                for K, N in ((2048, 8192), (2048, 2048), (2048, 1024),
                             (8192, 2048), (2048, 92544))]
EDGE_SHAPES = [(1, 1, 1), (4, 1, 37), (4, 31, 37), (4, 33, 37), (17, 70, 37),
               (16, 8192, 1003), (4, 65, 9), (3, 1 << 20, 5)]
CUTOFFS = [(16, "nbit"), (16, "full"), (16, "eq8"), (8, "nbit"), (8, "full"),
           (8, "eq8")]


def _levels(n_bits, mode, plane_bits=4):
    D = tref.num_planes_for(n_bits, plane_bits)
    return D, min(tref.kept_levels(n_bits, plane_bits, mode=mode), 2 * D - 1)


@pytest.mark.parametrize("n_bits,mode", CUTOFFS)
@pytest.mark.parametrize("shape", SERVE_SHAPES + EDGE_SHAPES)
def test_split_plan_covers_k_exactly(shape, n_bits, mode):
    M, K, N = shape
    D, levels = _levels(n_bits, mode)
    splits, k_split = tkernel.split_plan(M, N, K, D, levels, 4, sms=132)
    assert k_split % tkernel.BK == 0 and 1 <= splits <= tkernel.MAX_SPLITS
    # every slice [s * k_split, min(K, (s + 1) * k_split)) is non-empty and
    # together they are K
    assert (splits - 1) * k_split < K <= splits * k_split
    # the int32 guard holds for the whole K, so for every partial sum
    assert (1 << 6) * D * K < 2 ** 31


@pytest.mark.parametrize("n_bits,mode", CUTOFFS)
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_split_plan_fills_the_card_at_serve_shapes(shape, n_bits, mode):
    M, K, N = shape
    D, levels = _levels(n_bits, mode)
    bm, bn = tkernel.tile_shape(M, D, levels)
    splits, _ = tkernel.split_plan(M, N, K, D, levels, 4, sms=132)
    blocks = -(-M // bm) * -(-N // bn) * splits
    assert blocks >= 132
    assert splits == 1 or blocks <= 2 * tkernel.WAVES * 132


def test_split_plan_keeps_the_int32_guard():
    # 2^(2b-2) * D * K must stay below 2^31: K = 2^23 at b = 4, D = 4 is
    # the first K past it, and the plan refuses it as the kernel did
    assert tkernel.split_plan(4, 8, (1 << 23) - 1, 4, 4, 4)[0] >= 1
    with pytest.raises(ValueError, match="overflows the int32 level sum"):
        tkernel.split_plan(4, 8, 1 << 23, 4, 4, 4)
    with pytest.raises(ValueError, match="overflows the int32 level sum"):
        tkernel.split_plan(4, 8, 1 << 21, 4, 4, 6)


@pytest.mark.parametrize("shape", [(1, 16), (4, 16), (17, 16), (64, 16),
                                   (4, 8), (64, 4), (4, 2), (64, 2)])
def test_tile_shape_holds_every_row_of_a_decode(shape):
    M, D = shape
    for levels in (1, D, 2 * D - 1):
        bm, bn = tkernel.tile_shape(M, D, levels)
        # the counters of the workspace are sized for 16 x 8 tiles
        assert bm % 16 == 0 and bn % 8 == 0
        if M <= tkernel.GEMV_ROWS:
            assert bm == 16


def _fold(level_sums, sa, sb, plane_bits):
    """tpmm_ref's fold of int32 level sums, in float32."""
    out = None
    for L, acc in enumerate(level_sums):
        term = acc.to(torch.float32) * (2.0 ** (-plane_bits * (L + 2)))
        out = term if out is None else out + term
    return out * sa * sb


@pytest.mark.parametrize("n_bits,mode", CUTOFFS)
@settings(max_examples=12, deadline=None)
@given(data=st.data())
def test_split_k_int32_partials_fold_to_tpmm_ref(n_bits, mode, data):
    # The premise of the kernel's split K: int32 level partials over any
    # slices of K, added in any order, then folded, are tpmm_ref's bits.
    M = data.draw(st.integers(1, 5), label="M")
    K = data.draw(st.integers(1, 160), label="K")
    N = data.draw(st.integers(1, 6), label="N")
    a, b = _operands(data.draw(st.integers(0, 2 ** 32 - 1), label="seed"),
                     M, K, N)
    ap, bp, sa, sb = tops.decompose_operands(
        torch.from_numpy(a), torch.from_numpy(b), n_bits=n_bits)
    D, levels = _levels(n_bits, mode)
    cuts = data.draw(st.sets(st.integers(1, K - 1), max_size=7)
                     if K > 1 else st.just(set()), label="cuts")
    bounds = [0, *sorted(cuts), K]
    partials = []
    for lo, hi in zip(bounds, bounds[1:]):
        for L in range(levels):
            part = torch.zeros((M, N), dtype=torch.int64)
            for da in range(max(0, L - D + 1), min(L, D - 1) + 1):
                part += (ap[da][:, lo:hi].to(torch.int64)
                         @ bp[L - da][lo:hi].to(torch.int64))
            partials.append((L, part.to(torch.int32)))
    order = data.draw(st.permutations(range(len(partials))), label="order")
    sums = torch.zeros((levels, M, N), dtype=torch.int32)
    for i in order:
        L, part = partials[i]
        sums[L] += part
    got = _fold(sums, sa, sb, 4)
    want = tref.tpmm_ref(ap, bp, sa, sb, n_bits=n_bits, mode=mode)
    assert np.array_equal(_bits(want.numpy()), _bits(got.numpy()))
    jwant = jops.tpmm(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                      mode=mode, use_pallas=False)
    assert np.array_equal(_bits(jwant), _bits(got.numpy()))


def test_cpu_tensors_run_the_plain_version():
    a, b = _operands(2, 3, 20, 4)
    before = tkernel.launches
    tops.tpmm(torch.from_numpy(a), torch.from_numpy(b))
    assert tkernel.launches == before
    planes = torch.zeros((4, 3, 20), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.tpmm_kernel(planes, planes.transpose(1, 2), torch.ones(3, 1),
                            torch.ones(1, 3), n_bits=16)


# --- the smoke model under tpmm16 --------------------------------------------

B, S = 2, 6


def _tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def tpmm16_logits():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCH), compute_dtype="float32")
    jm = JModel(jcfg, JEngine(mode="tpmm16"))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tm = Model(cfg, DotEngine(mode="tpmm16"), device="cpu")
    tp = params_from_jax(tree, cfg, device="cpu")
    toks = _tokens()
    lg, cache, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                              jm.init_cache(B, S + 2))
    lg2, _ = jm.decode_step(jp, jnp.asarray([3, 4]), jnp.asarray([S, S]), cache)
    tcache = tm.init_cache(B, S + 2)
    tlg, tcache, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    tlg2, _ = tm.decode_step(tp, torch.tensor([3, 4]), torch.tensor([S, S]),
                             tcache)
    native = JModel(jcfg, JEngine(mode="native")).init(jax.random.PRNGKey(0))
    return ((np.asarray(lg), np.asarray(lg2)), (tlg.numpy(), tlg2.numpy()),
            (tree, jax.tree.map(np.asarray, native), cfg))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_smoke_model_prefill_logits_under_tpmm16(tpmm16_logits):
    # f32 compute, 1e-3 of the largest |logit|: the tpmm GEMMs are
    # bit-identical given identical inputs, but RMSNorm, RoPE and softmax
    # differ between XLA and PyTorch by float32 ulps, and an input an ulp
    # from a rounding boundary moves one 2^-16 step of a plane digit.
    (want, _), (got, _), _ = tpmm16_logits
    assert got.shape == want.shape == (B, 512)
    assert _rel(want, got) <= 1e-3


def test_smoke_model_decode_logits_under_tpmm16(tpmm16_logits):
    (_, want), (_, got), _ = tpmm16_logits
    assert got.shape == want.shape == (B, 512)
    assert _rel(want, got) <= 1e-3


def test_weights_carry_over_unchanged_for_tpmm(tpmm16_logits):
    # every mode serves the same dense parameters: the reference's tree
    # under tpmm16 is its tree under native, and convert.py maps it as is
    _, _, (tree, native, cfg) = tpmm16_logits
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, native))
    tp = params_from_jax(tree, cfg, device="cpu")
    np.testing.assert_array_equal(tp["layers"][0]["mlp"]["wd"].numpy(),
                                  np.asarray(tree["blocks"]["scan"][0]["mlp"]
                                             ["wd"][0]))
