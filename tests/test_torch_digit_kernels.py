"""The port's digit-level kernels' plain versions on the CPU against the JAX
reference, bit for bit: `online_mul` (K4) and `online_dot` (K3) against the
TPU kernels `online_mul_pallas` / `online_dot_pallas` in interpret mode and
against the int64 references, including full working precision, the int32
guard, K in {1, 3, 16, 33, 64} and n in {8, 16, 32};
`olm_matmul(quantize="host")` (K2) against the reference's host-quantize
grid kernel at every olm mode; and `digit_traffic` against the exact-int
columns of the committed baselines. Inputs are made from a seed with
numpy."""
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.kernels import common as jc
from repro.kernels.online_dot import matmul as jmm
from repro.kernels.online_dot import ops as jdot
from repro.kernels.online_dot.kernel import online_dot_pallas
from repro.kernels.online_dot.ref import online_dot_batch_ref as j_dot_ref
from repro.kernels.online_mul.kernel import online_mul_pallas
from repro.kernels.online_mul.ref import online_mul_batch_ref as j_mul_ref
from repro_torch.core.numerics import DotEngine
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import common as tc
from repro_torch.kernels.online_dot import kernel as dot_kernel
from repro_torch.kernels.online_dot import matmul as tmm
from repro_torch.kernels.online_dot import matmul_kernel
from repro_torch.kernels.online_dot.ops import (dot_scale_log2,
                                                dot_stream_length, online_dot)
from repro_torch.kernels.online_dot.ref import online_dot_batch_ref
from repro_torch.kernels.online_mul import kernel as mul_kernel
from repro_torch.kernels.online_mul.ops import online_mul

BASELINE = pathlib.Path(__file__).resolve().parents[1] / "results" / "baseline"
OLM_MODES = sorted(m for m in DotEngine.modes() if m.startswith("olm"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digits(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, size=shape).astype(np.int32),
            rng.integers(-1, 2, size=shape).astype(np.int32))


def _cfg_kw(cfg):
    return dict(n=cfg.n, truncated=cfg.truncated, tail_gating=cfg.tail_gating)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# --- online_mul (K4) --------------------------------------------------------

@pytest.mark.parametrize("n,truncated", [(8, True), (16, True), (24, True),
                                         (32, True), (8, False), (16, False),
                                         (24, False)])
def test_online_mul_matches_tpu_kernel_and_reference(n, truncated):
    cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
    xd, yd = _digits(n + truncated, (37, n))
    z, z_int = online_mul(torch.from_numpy(xd), torch.from_numpy(yd), cfg)
    want = online_mul_pallas(xd, yd, block_b=37, interpret=True,
                             **_cfg_kw(cfg))
    with enable_x64(True):
        ref, ref_int = j_mul_ref(xd, yd, **_cfg_kw(cfg))
        ref, ref_int = np.asarray(ref), np.asarray(ref_int)
    assert z.dtype == torch.int32 and z_int.dtype == torch.int64
    assert np.array_equal(z.numpy(), np.asarray(want))
    assert np.array_equal(z.numpy(), ref)
    assert np.array_equal(z_int.numpy(), ref_int)
    assert np.array_equal(z_int.numpy(), jc.decode_digits(np.asarray(want), n))


def test_online_mul_int32_guard_takes_the_plain_version():
    # full working precision at n = 32 needs 38 bits: the reference refuses
    # the kernel, the dispatch picks the int64 version before any launch
    cfg = OnlinePrecision(n=32, truncated=False, tail_gating=False)
    assert not tc.fits_int32(cfg) and not tc.resolve_use_pallas(cfg, True)
    assert tc.resolve_use_pallas(OnlinePrecision(n=32), None)
    assert not tc.resolve_use_pallas(OnlinePrecision(n=32), False)
    with pytest.raises(ValueError):
        online_mul_pallas(np.zeros((8, 32), np.int32),
                          np.zeros((8, 32), np.int32), n=32, truncated=False,
                          tail_gating=False, block_b=8)
    with pytest.raises(ValueError, match="int32 datapath"):
        mul_kernel.check_config(cfg)
    xd, yd = _digits(5, (16, 32))
    z, z_int = online_mul(torch.from_numpy(xd), torch.from_numpy(yd), cfg,
                          use_pallas=True)
    with enable_x64(True):
        ref, ref_int = j_mul_ref(xd, yd, **_cfg_kw(cfg))
        assert np.array_equal(z.numpy(), np.asarray(ref))
        assert np.array_equal(z_int.numpy(), np.asarray(ref_int))


def test_decode_digits_matches_reference():
    xd, _ = _digits(2, (9, 32))
    assert np.array_equal(tc.decode_digits(torch.from_numpy(xd), 32).numpy(),
                          jc.decode_digits(xd, 32))


# --- online_dot (K3) --------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 16, 33, 64])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_online_dot_matches_tpu_kernel_and_reference(K, n):
    cfg = OnlinePrecision(n=n)
    xd, yd = _digits(K * n, (6, K, n))
    z, dot = online_dot(torch.from_numpy(xd), torch.from_numpy(yd), cfg)
    assert z.shape == (6, dot_stream_length(n, K))
    want = online_dot_pallas(xd, yd, n=n, block_b=6, interpret=True)
    assert np.array_equal(z.numpy(), np.asarray(want))
    ref = online_dot_batch_ref(torch.from_numpy(xd), torch.from_numpy(yd), n=n)
    with enable_x64(True):   # the int64 recurrence of n = 32 needs 38 bits
        jref = np.asarray(j_dot_ref(xd, yd, n=n))
        _, jval = jdot.online_dot(xd, yd, cfg, use_pallas=False)
        jval = np.asarray(jval)
    assert np.array_equal(ref.numpy(), jref)
    assert np.array_equal(z.numpy(), ref.numpy())
    assert dot.dtype == torch.float64 and np.array_equal(dot.numpy(), jval)


def test_online_dot_full_working_precision():
    cfg = OnlinePrecision(n=16, truncated=False, tail_gating=False)
    xd, yd = _digits(3, (4, 5, 16))
    z, dot = online_dot(torch.from_numpy(xd), torch.from_numpy(yd), cfg)
    want = online_dot_pallas(xd, yd, block_b=4, interpret=True,
                             **_cfg_kw(cfg))
    assert np.array_equal(z.numpy(), np.asarray(want))


def test_online_dot_int32_guard_takes_the_plain_version():
    cfg = OnlinePrecision(n=32, truncated=False, tail_gating=False)
    xd, yd = _digits(4, (3, 4, 32))
    with pytest.raises(ValueError):
        online_dot_pallas(xd, xd, n=32, truncated=False, tail_gating=False,
                          block_b=3)
    z, dot = online_dot(torch.from_numpy(xd), torch.from_numpy(yd), cfg)
    with enable_x64(True):
        want = j_dot_ref(xd, yd, **_cfg_kw(cfg))
        assert np.array_equal(z.numpy(), np.asarray(want))


def test_stream_geometry():
    assert [dot_scale_log2(k) for k in (1, 2, 3, 256)] == [0, 1, 2, 8]
    assert dot_stream_length(8, 1) == jdot.dot_stream_length(8, 1) == 8
    assert dot_stream_length(16, 8) == jdot.dot_stream_length(16, 8) == 22


def test_cpu_tensors_never_launch_and_wrappers_refuse_them():
    cfg = OnlinePrecision(n=8)
    xd, yd = _digits(6, (4, 3, 8))
    x3, y3 = torch.from_numpy(xd), torch.from_numpy(yd)
    before = (mul_kernel.launches, dot_kernel.launches,
              matmul_kernel.host_launches)
    online_mul(x3[:, 0].contiguous(), y3[:, 0].contiguous(), cfg)
    online_dot(x3, y3, cfg)
    assert (mul_kernel.launches, dot_kernel.launches,
            matmul_kernel.host_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        mul_kernel.online_mul_kernel(x3[:, 0], y3[:, 0], cfg)
    with pytest.raises(ValueError, match="CUDA"):
        dot_kernel.online_dot_kernel(x3, y3, cfg)
    xg = torch.zeros((2, 1, 16, 8), dtype=torch.int32)
    s = torch.ones((2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_kernel.olm_matmul_host(xg, s, xg, s, n=8)


def test_kernels_refuse_other_delay_or_estimate():
    # Another delay or estimate width runs on a kernel (the general one;
    # the unrolled one runs the paper's delta 3, t 2), a negative delay and
    # an estimate wider than the datapath (S < t) too; what stays refused,
    # before any launch, is a residual the selection does not bound whose
    # bound leaves int64 (a delay of 1 at n = 36).
    for cfg, route in ((OnlinePrecision(n=8, delta=4), "any"),
                       (OnlinePrecision(n=8, t=3), "any"),
                       (OnlinePrecision(n=8), "unrolled"),
                       (OnlinePrecision(n=8, delta=0), "any"),
                       (OnlinePrecision(n=8, delta=-1), "any"),
                       (OnlinePrecision(n=2, delta=0, t=5, truncated=False),
                        "any")):
        mul_kernel.check_config(cfg)
        assert mul_kernel.holds(cfg) and mul_kernel.route(cfg) == route
        assert dot_kernel.holds(cfg, 8)
    cfg = OnlinePrecision(n=36, delta=1)
    with pytest.raises(ValueError, match="does not bound the residual"):
        mul_kernel.check_config(cfg)
    assert not mul_kernel.holds(cfg) and not dot_kernel.holds(cfg, 8)


# --- olm_matmul(quantize="host") (K2) ----------------------------------------

def _mode_bits(mode):
    n, p = re.fullmatch(r"olm(\d+)(?:t(\d+))?", mode).groups()
    return int(n), (int(p) if p else None)


@pytest.mark.parametrize("mode", OLM_MODES)
def test_host_quantize_path_matches_tpu_kernel(mode):
    n, p = _mode_bits(mode)
    rng = np.random.default_rng(OLM_MODES.index(mode))
    x = rng.standard_normal((3, 21)).astype(np.float32)
    w = (rng.standard_normal((21, 5)) * 0.05).astype(np.float32)
    want = jmm.olm_matmul(jnp.asarray(x), jnp.asarray(w), n_bits=n, trunc=p,
                          use_pallas=True, quantize="host", interpret=True)
    got = tmm.olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=n,
                         trunc=p, quantize="host")
    assert np.array_equal(_bits(want), _bits(got.numpy())), mode


def test_quantize_must_be_kernel_or_host():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="quantize"):
        tmm.olm_matmul(x, x.T, quantize="device")


# --- digit_traffic ------------------------------------------------------------

def _baseline(name):
    return json.loads((BASELINE / f"BENCH_{name}.json").read_text())["rows"]


def test_digit_traffic_matches_reference_at_many_shapes():
    for M, K, N in ((1, 1, 1), (3, 70, 9), (64, 32, 64), (100, 33, 7)):
        for n, p in ((8, None), (16, None), (32, 20)):
            for bm, bn in ((8, 8), (4, 16)):
                kw = dict(n_bits=n, trunc=p, block_m=bm, block_n=bn)
                assert (tmm.digit_traffic(M, N, K, **kw)
                        == jmm.digit_traffic(M, N, K, **kw))


def test_digit_traffic_matches_olm_matmul_baseline():
    rows = _baseline("olm_matmul")
    shapes = {16: (8, 16, 8), 64: (8, 64, 8), 32: (64, 32, 64)}
    col = {"olm_matmul/bcast": "broadcast_bytes",
           "olm_matmul/grid": "grid_bytes"}
    for r in rows:
        M, K, N = shapes[r["k"]]
        tr = tmm.digit_traffic(M, N, K, n_bits=r["n"])
        assert tr[col[r["op"]]] == r["bytes_moved"], r
        assert tr["fused_bytes"] == r["bytes_float"], r
    assert len(rows) == 16


def test_digit_traffic_matches_fused_and_truncated_baselines():
    col = {"bcast": "broadcast_bytes", "grid-host": "grid_bytes",
           "grid-fused": "fused_bytes"}
    fused = _baseline("olm_matmul_fused")
    for r in fused:
        tr = tmm.digit_traffic(64, 64, 32, n_bits=r["n"])
        assert tr[col[r["op"].split("/")[1]]] == r["bytes_moved"], r
    trunc = [r for r in _baseline("olm_matmul_truncated") if "bytes_moved" in r]
    for r in trunc:
        tier = r["op"].split("/")[1]
        p = None if tier == "full" else int(tier[1:])
        tr = tmm.digit_traffic(64, 64, 32, n_bits=r["n"], trunc=p)
        assert tr["grid_bytes"] == r["bytes_moved"], r
    assert len(fused) == 12 and len(trunc) == 7
