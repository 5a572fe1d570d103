"""The port's olm matmul on the CPU against the JAX reference, bit for bit:
against the TPU kernel K1 (`olm_matmul_fused_pallas`) run in interpret
mode, and against the reference's broadcast oracle `olm_matmul_ref` at
every registered olm mode, on ragged shapes and a GEMV. Bits are compared
through int32 views (0 ulp)."""
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.numerics import DotEngine as JEngine
from repro.kernels.online_dot import matmul as jmm
from repro_torch.core.numerics import DotEngine
from repro_torch.kernels.online_dot import matmul as tmm
from repro_torch.kernels.online_dot import matmul_kernel

OLM_MODES = sorted(m for m in DotEngine.modes() if m.startswith("olm"))
SHAPES = list(itertools.product((1, 5), (16, 70), (7, 33)))   # (M, K, N)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mode_bits(mode):
    n, p = re.fullmatch(r"olm(\d+)(?:t(\d+))?", mode).groups()
    return int(n), (int(p) if p else None)


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x[0, : min(K, 16)] *= np.float32(2.0 ** -20)   # a tile far below the rest
    return x, w


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_registry_matches_reference():
    assert set(DotEngine.modes()) == set(JEngine.modes())


@pytest.mark.parametrize("mode", OLM_MODES)
def test_matches_reference_oracle_every_mode(mode):
    i = OLM_MODES.index(mode)
    M, K, N = SHAPES[i % len(SHAPES)]
    n, p = _mode_bits(mode)
    x, w = _operands(i, M, K, N)
    want = jmm.olm_matmul_ref(jnp.asarray(x), jnp.asarray(w), n_bits=n, trunc=p)
    got = tmm.olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=n,
                         trunc=p)
    via_engine = DotEngine(mode=mode).dot(torch.from_numpy(x),
                                          torch.from_numpy(w))
    assert np.array_equal(_bits(want), _bits(got.numpy())), mode
    assert np.array_equal(_bits(got.numpy()), _bits(via_engine.numpy())), mode


@pytest.mark.parametrize("mode", ["olm8", "olm16", "olm16t12", "olm24", "olm32"])
def test_matches_tpu_kernel_in_interpret_mode(mode):
    n, p = _mode_bits(mode)
    x, w = _operands(11, 5, 70, 37)
    want = jmm.olm_matmul(jnp.asarray(x), jnp.asarray(w), n_bits=n, trunc=p,
                          use_pallas=True, quantize="kernel", interpret=True)
    got = tmm.olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=n,
                         trunc=p)
    assert np.array_equal(_bits(want), _bits(got.numpy())), mode


@pytest.mark.parametrize("n,p", [(16, None), (32, None), (16, 12), (32, 16)])
def test_error_bound_equals_reference(n, p):
    x, w = _operands(5, 5, 70, 33)
    want = jmm.olm_error_bound(jnp.asarray(x), jnp.asarray(w), n_bits=n, trunc=p)
    got = tmm.olm_error_bound(torch.from_numpy(x), torch.from_numpy(w),
                              n_bits=n, trunc=p)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("n", [8, 16])
def test_within_error_bound_of_exact_product(n):
    x, w = _operands(9, 5, 70, 33)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    exact = xt.double() @ wt.double()
    err = (tmm.olm_matmul(xt, wt, n_bits=n).double() - exact).abs()
    assert bool((err <= tmm.olm_error_bound(xt, wt, n_bits=n).double()).all())


def test_lowered_dot_keeps_reference_casts():
    # bf16 activations, f32 weights: the weights reach the array in f32,
    # the output returns in bf16 -- the same bits as the reference.
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 9)) * 0.1).astype(np.float32)
    want = JEngine(mode="olm16").dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    got = DotEngine(mode="olm16").dot(torch.from_numpy(x).to(torch.bfloat16),
                                      torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 9)
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.to(torch.float32).numpy())


def test_cpu_tensors_run_the_plain_version():
    x, w = _operands(2, 3, 20, 4)
    before = matmul_kernel.launches
    tmm.olm_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert matmul_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = _operands(2, 3, 20, 4)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_kernel.olm_matmul_fused(torch.from_numpy(x),
                                       torch.from_numpy(w), n=16)


def test_unservable_stream_refused():
    x, w = _operands(2, 3, 300, 4)       # 32 + 2 * 9 tree levels > 48
    with pytest.raises(ValueError, match="decode window"):
        tmm.olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=32,
                       k_tile=300)


def test_kernel_op_count_scales_with_work():
    one = matmul_kernel.int_ops(4, 8, 16, n=16)
    assert matmul_kernel.int_ops(8, 8, 16, n=16) > one
    assert matmul_kernel.int_ops(4, 8, 32, n=16) == 2 * one


@pytest.mark.parametrize("n,p", [(8, None), (16, None), (32, None), (16, 12),
                                 (32, 16)])
def test_engine_for_names_the_reference_mode(n, p):
    from repro.configs.olm_array import engine_for as jengine_for
    from repro_torch.configs.olm_array import engine_for
    eng = engine_for(n, trunc=p)
    assert eng.mode == jengine_for(n, trunc=p).mode and eng.tiling == "auto"


def test_layer_modes_route_roles():
    eng = DotEngine(mode="olm16", layer_modes={"head": "olm32", "mlp": "olm16"})
    assert eng.for_role("head").mode == "olm32"
    assert eng.for_role("mlp") is eng and eng.for_role("attn") is eng
    with pytest.raises(ValueError):
        eng.for_role("moe")
    assert DotEngine(mode="olm16",
                     layer_modes={"head": "tpmm8"}).for_role("head").mode == "tpmm8"
    with pytest.raises(ValueError):
        DotEngine(mode="olm16", layer_modes={"head": "tpmm12"})
    with pytest.raises(ValueError):
        DotEngine(mode="olm64")
