"""The port's quantization and decode plumbing against the JAX reference
(`repro.kernels.common`): pow2 scales, signed-digit quantization at every
array width, both stream decodes, and the subnormal flush, all bit for bit
on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jc
from repro_torch.kernels import common as tc
from repro_torch.kernels.online_dot.matmul import olm_matmul


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slices(seed, shape=(6, 16)):
    """Rows spanning many binades, with a power-of-two max, an all-zero
    row and an all-subnormal row among them."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, (shape[0], 1)))
         ).astype(np.float32)
    a[1] = 0.0
    a[2] = np.float32(2.0 ** 5) * np.sign(rng.standard_normal(shape[1]))
    a[3] = (rng.standard_normal(shape[1]) * 1e-40).astype(np.float32)
    return a


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def test_pow2_scale_bit_identical():
    a = _slices(0)
    want = np.asarray(jc.pow2_scale(jnp.asarray(a), -1))
    got = tc.pow2_scale(torch.from_numpy(a), -1).numpy()
    assert _bits_equal(want, got)


def test_pow2_scale_axis0():
    a = _slices(1)
    want = np.asarray(jc.pow2_scale(jnp.asarray(a), 0))
    got = tc.pow2_scale(torch.from_numpy(a), 0).numpy()
    assert _bits_equal(want, got)


@pytest.mark.parametrize("n", [8, 16, 24, 32])
def test_sd_quantize_bit_identical(n):
    a = _slices(n)
    wd, ws = jc.sd_quantize(jnp.asarray(a), n=n, axis=-1)
    td, ts = tc.sd_quantize(torch.from_numpy(a), n=n, axis=-1)
    assert np.array_equal(np.asarray(wd), td.numpy())
    assert _bits_equal(ws, ts.numpy())


def test_sd_quantize_n32_endpoint():
    # |a| = max and a power of two: u = a / scale = +-1/2 exactly, the
    # closed endpoint whose magnitude at n = 32 is 2^31 (past int32).
    a = np.array([[4.0, -4.0, 1.0, 0.0]], np.float32)
    wd, ws = jc.sd_quantize(jnp.asarray(a), n=32)
    td, ts = tc.sd_quantize(torch.from_numpy(a), n=32)
    assert np.array_equal(np.asarray(wd), td.numpy())
    assert _bits_equal(ws, ts.numpy())
    assert td[0, 0, 0] == 1 and td[0, 1, 0] == -1 and int(td[0, 0, 1:].abs().sum()) == 0


def test_sd_quantize_other_axis():
    a = _slices(7, (16, 5))
    wd, ws = jc.sd_quantize(jnp.asarray(a), n=16, axis=0)
    td, ts = tc.sd_quantize(torch.from_numpy(a), n=16, axis=0)
    assert np.array_equal(np.asarray(wd), td.numpy())
    assert _bits_equal(ws, ts.numpy())


@pytest.mark.parametrize("m", [8, 20, 24])
def test_decode_stream_f32_bit_identical(m):
    d = np.random.default_rng(m).integers(-1, 2, (64, m)).astype(np.int32)
    want = np.asarray(jc.decode_stream_jnp(jnp.asarray(d)))
    assert _bits_equal(want, tc.decode_stream(torch.from_numpy(d)).numpy())


@pytest.mark.parametrize("m", [25, 32, 40, 48])
def test_decode_stream_wide_matches_two_limb(m):
    # The reference runs without x64 here, so it takes its two-limb f32
    # branch; the port's int64 branch must give the same bits.
    d = np.random.default_rng(m).integers(-1, 2, (256, m)).astype(np.int32)
    want = np.asarray(jc.decode_stream_wide_jnp(jnp.asarray(d)))
    assert _bits_equal(want, tc.decode_stream_wide(torch.from_numpy(d)).numpy())


def test_decode_policy_windows():
    for m in (1, 24, 25, 48):
        assert tc.decode_policy(m) == jc.decode_policy(m)
    with pytest.raises(ValueError):
        tc.decode_policy(49)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_checked_schedule_matches(n):
    from repro.core.precision import OnlinePrecision as JP
    from repro_torch.core.precision import OnlinePrecision as TP
    ws, wS = jc.checked_schedule(JP(n=n))
    ts, tS = tc.checked_schedule(TP(n=n))
    assert np.array_equal(ws, ts) and wS == tS
    assert not tc.fits_int32(TP(n=32, truncated=False, tail_gating=False))


def test_subnormal_slice_flushes_like_reference():
    # XLA:CPU (like the TPU) treats a subnormal max as zero: scale 1.0 and
    # all-zero digits. The port flushes explicitly to keep bit-identity.
    a = np.array([[1e-40, -3e-41]], np.float32)
    assert float(np.asarray(jc.pow2_scale(jnp.asarray(a), -1))[0, 0]) == 1.0
    assert float(tc.pow2_scale(torch.from_numpy(a), -1)[0, 0]) == 1.0
    x = np.full((1, 16), 3e-39, np.float32)
    x[0, ::3] = -1e-41
    td, ts = tc.sd_quantize(torch.from_numpy(x), n=16)
    wd, ws = jc.sd_quantize(jnp.asarray(x), n=16)
    assert int(td.abs().sum()) == 0 and float(ts[0, 0]) == 1.0
    assert np.array_equal(np.asarray(wd), td.numpy()) and _bits_equal(ws, ts.numpy())


def test_subnormal_tile_contributes_zero_to_matmul():
    # One all-subnormal K tile of x: its contribution through the port's
    # olm_matmul is exactly zero, so the product equals the one with that
    # tile zeroed, bit for bit.
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 5)).astype(np.float32)
    x[:, :16] = (rng.standard_normal((3, 16)) * 1e-40).astype(np.float32)
    x0 = x.copy()
    x0[:, :16] = 0.0
    got = olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=16)
    zeroed = olm_matmul(torch.from_numpy(x0), torch.from_numpy(w), n_bits=16)
    assert _bits_equal(got.numpy(), zeroed.numpy())
