"""Card-only tests of the port: the hand-written Hopper kernel against its
plain PyTorch version on the card. A CUDA kernel has no interpret mode, so
these skip where there is no card (the fixture decides, at run time).
On the card: PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.kernels.online_dot import matmul_kernel
from repro_torch.kernels.online_dot.matmul import olm_matmul, olm_matmul_ref
from repro_torch.models.model import Model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the Hopper kernels run only on the card")
    return torch.device("cuda")


def _operands(cuda, M, K, N, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g)
    w = torch.randn(K, N, device=cuda, generator=g) * 0.05
    x[0, : min(K, 16)] = 1e-40          # an all-subnormal slice
    return x, w


@pytest.mark.parametrize("n,p", [(8, None), (16, None), (16, 12), (24, None),
                                 (32, None), (32, 20)])
def test_kernel_bit_identical_to_plain(cuda, n, p):
    x, w = _operands(cuda, 5, 70, 37)
    got = olm_matmul(x, w, n_bits=n, trunc=p)
    want = olm_matmul_ref(x, w, n_bits=n, trunc=p)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_kernel_reads_transposed_weights(cuda):
    x, _ = _operands(cuda, 3, 40, 9)
    wt = torch.randn(9, 40, device=cuda)
    got = matmul_kernel.olm_matmul_fused(x, wt.t(), n=16)
    want = olm_matmul_ref(x, wt.t(), n_bits=16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_launches_counted_once_per_gemm(cuda):
    x, w = _operands(cuda, 4, 32, 8)
    before = matmul_kernel.launches
    DotEngine(mode="olm16").dot(x, w)
    assert matmul_kernel.launches == before + 1


def test_model_prefill_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"),
                              compute_dtype="float32", dot_mode="olm16")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(seed=0)
    gpu = Model(cfg, device=cuda)
    gparams = {k: ([{a: {b: t.to(cuda) for b, t in d.items()}
                     for a, d in layer.items()} for layer in v]
                   if k == "layers" else {b: t.to(cuda) for b, t in v.items()})
               for k, v in params.items()}
    toks = torch.randint(0, 512, (2, 5), generator=torch.Generator().manual_seed(0))
    want, _, _ = cpu.prefill(params, {"tokens": toks}, cpu.init_cache(2, 8))
    got, _, _ = gpu.prefill(gparams, {"tokens": toks}, gpu.init_cache(2, 8))
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-3


def test_bf16_activations_through_engine(cuda):
    # bf16 activations and an f32 weight, and a bf16-rounded table read
    # through a transposed view (the LM head): the card gives the plain
    # version's bits.
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 40, generator=g).to(torch.bfloat16)
    w = torch.randn(40, 9, generator=g) * 0.1
    table = torch.randn(9, 40, generator=g).to(torch.bfloat16)
    eng = DotEngine(mode="olm16")
    for a, b in ((x, w), (x, table.T)):
        want = eng.dot(a, b)
        got = eng.dot(a.to(cuda), b.to(cuda))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
