"""Card-only tests of the port: each hand-written Hopper kernel against its
plain PyTorch version on the card, bit for bit. A CUDA kernel has no interpret mode, so
these skip where there is no card (the fixture decides, at run time).
On the card: PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import kernel as dot_kernel
from repro_torch.kernels.online_dot import matmul_kernel
from repro_torch.kernels.online_dot.matmul import olm_matmul, olm_matmul_ref
from repro_torch.kernels.online_dot.ops import online_dot
from repro_torch.kernels.online_dot.ref import (online_dot_batch_ref,
                                                tree_levels)
from repro_torch.kernels.online_mul import kernel as mul_kernel
from repro_torch.kernels.online_mul.ops import online_mul
from repro_torch.kernels.online_mul.ref import online_mul_batch_ref
from repro_torch.kernels.tpmm import kernel as tpmm_kernel
from repro_torch.kernels.tpmm.ops import tpmm
from repro_torch.kernels.tpmm.quantize import plane_decompose
from repro_torch.kernels.tpmm.ref import tpmm_ref
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
    before = matmul_kernel.launches, tpmm_kernel.launches
    DotEngine(mode="olm16").dot(x, w)
    DotEngine(mode="tpmm8").dot(x, w)
    assert (matmul_kernel.launches, tpmm_kernel.launches) == (before[0] + 1,
                                                              before[1] + 1)


@pytest.mark.parametrize("n,p", [(8, None), (16, None), (16, 10), (32, None)])
def test_host_quantize_kernel_bit_identical(cuda, n, p):
    x, w = _operands(cuda, 5, 70, 37)
    before = matmul_kernel.host_launches
    got = olm_matmul(x, w, n_bits=n, trunc=p, quantize="host")
    torch.cuda.synchronize()
    assert matmul_kernel.host_launches == before + 1
    for want in (olm_matmul_ref(x, w, n_bits=n, trunc=p),
                 olm_matmul(x, w, n_bits=n, trunc=p)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _mode_bits(mode):
    n, _, p = mode[len("olm"):].partition("t")
    return int(n), (int(p) if p else None)


@pytest.mark.parametrize("mode", sorted(m for m in DotEngine.modes()
                                        if m.startswith("olm")))
def test_both_kernels_at_every_olm_mode_and_tier(cuda, mode):
    # K1 and K2 at every width and truncated tier on a ragged shape, against
    # the plain version and against each other, bit for bit
    n, p = _mode_bits(mode)
    x, w = _operands(cuda, 5, 70, 37)
    fused = olm_matmul(x, w, n_bits=n, trunc=p)
    host = olm_matmul(x, w, n_bits=n, trunc=p, quantize="host")
    want = olm_matmul_ref(x, w, n_bits=n, trunc=p)
    assert _bits_equal(fused, want) and _bits_equal(host, want)


# K of one lane, a two-level tree, a short tile, one and 17 lanes past a
# tile; M on both sides of the 4- and 8-row blocks with N not a power of
# two; one row and three columns of a long K (blocks of more than 32 K
# tiles); at olm16, olm24 (the 32-bit stream's limit) and olm32 (64-bit)
K12_EDGES = ([(5, K, 37) for K in (1, 3, 15, 17, 33)]
             + [(M, 70, 1003) for M in (1, 5, 17)] + [(1, 8192, 3)])


@pytest.mark.parametrize("shape", K12_EDGES)
@pytest.mark.parametrize("n", [16, 24, 32])
def test_both_kernels_at_their_edges(cuda, shape, n):
    x, w = _operands(cuda, *shape, seed=sum(shape) + n)
    want = olm_matmul_ref(x, w, n_bits=n)
    fused = matmul_kernel.olm_matmul_fused(x, w, n=n)
    transposed = matmul_kernel.olm_matmul_fused(x, w.t().contiguous().t(),
                                                n=n)
    host = olm_matmul(x, w, n_bits=n, quantize="host")
    for got in (fused, transposed, host):
        assert _bits_equal(got, want)


@pytest.mark.parametrize("k_tile", [5, 8])
def test_both_kernels_at_a_narrower_k_tile(cuda, k_tile):
    x, w = _operands(cuda, 5, 70, 37)
    want = olm_matmul_ref(x, w, n_bits=16, k_tile=k_tile)
    for quantize in ("kernel", "host"):
        assert _bits_equal(olm_matmul(x, w, n_bits=16, k_tile=k_tile,
                                      quantize=quantize), want)


def test_both_kernels_at_the_lm_head(cuda):
    # M = 4 N = 92544: 1446 column blocks of the plan
    x, w = _operands(cuda, 4, 2048, 92544)
    want = olm_matmul_ref(x, w)
    assert _bits_equal(olm_matmul(x, w), want)
    assert _bits_equal(olm_matmul(x, w, quantize="host"), want)


@pytest.mark.parametrize("shape", [(M, K, N) for M in (4, 64)
                                   for K, N in ((2048, 8192), (2048, 2048),
                                                (2048, 1024), (8192, 2048))])
def test_both_kernels_at_the_serve_shapes(cuda, shape):
    # the olm16 serve's q/o, k/v, gate/up and down GEMMs at decode and
    # prefill, each under its own launch plan
    x, w = _operands(cuda, *shape, seed=sum(shape))
    want = olm_matmul_ref(x, w)
    assert _bits_equal(olm_matmul(x, w), want)
    assert _bits_equal(olm_matmul(x, w, quantize="host"), want)


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 256), (4096, 13696),
                                 (13696, 4096), (4096, 65024)])
def test_fused_kernel_at_the_chatglm3_shapes(cuda, K, N):
    # ChatGLM3-6B's q/o, k/v (2 KV heads of 128), gate/up, down and head
    # at the 4-lane decode: K = 13696 is 856 K tiles, N = 256 few column
    # blocks
    x, w = _operands(cuda, 4, K, N, seed=K + N)
    before = matmul_kernel.launches
    got = olm_matmul(x, w)
    assert matmul_kernel.launches == before + 1
    assert _bits_equal(got, olm_matmul_ref(x, w))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_forward_last_position_equals_prefill_on_card(cuda, dt):
    # ChatGLM3's smoke config (QKV bias, half RoPE) under olm16: forward's
    # logits at the last position are prefill's, bit for bit
    cfg = dataclasses.replace(smoke_config("chatglm3_6b"), compute_dtype=dt,
                              dot_mode="olm16")
    m = Model(cfg, device=cuda)
    params = m.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    for layer in params["layers"]:
        for key in ("bq", "bk", "bv"):
            layer["attn"][key].copy_(0.5 * torch.randn(
                layer["attn"][key].shape, generator=g, device=cuda))
    toks = torch.randint(0, 512, (2, 9), generator=g, device=cuda)
    logits, _ = m.forward(params, {"tokens": toks})
    last, _, _ = m.prefill(params, {"tokens": toks}, m.init_cache(2, 9))
    assert _bits_equal(logits[:, -1].contiguous(), last)


def test_host_kernel_flushes_a_subnormal_tile(cuda):
    # _operands puts 1e-40 in x[0, :16]: that tile contributes exactly 0
    x, w = _operands(cuda, 5, 70, 37)
    zeroed = x.clone()
    zeroed[0, :16] = 0.0
    got = olm_matmul(x, w, quantize="host")
    assert _bits_equal(got, olm_matmul_ref(x, w))
    assert _bits_equal(got, olm_matmul(zeroed, w, quantize="host"))


def test_olm_matmul_plan_knows_the_kernels_shared_memory(cuda):
    # launch_plan counts shared memory the way csrc/olm_matmul.cu's layout
    # does; the kernel reports its own, and an SM holds such a block
    for n in (8, 10, 12, 16, 20, 24, 32):
        for host, vec in ((False, False), (True, False), (True, True)):
            if vec and n % 4:
                continue
            for M, N, K in ((4, 8192, 2048), (64, 2048, 2048),
                            (4, 92544, 2048), (1, 1, 8192), (5, 37, 70),
                            (17, 1003, 3)):
                plan = matmul_kernel.launch_plan(M, N, K, n, host=host,
                                                 vec=vec)
                L = tree_levels(plan.kt)
                if n + 2 * L > 48:
                    continue
                smem, blocks = matmul_kernel.geometry(n, host, vec, plan.bm,
                                                      plan.bn, plan.tb, L)
                assert smem == plan.smem, (n, host, vec, M, N, K)
                assert blocks >= 1, (n, host, vec, M, N, K)


def _digits(cuda, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randint(-1, 2, shape, device=cuda, generator=g,
                          dtype=torch.int32),
            torch.randint(-1, 2, shape, device=cuda, generator=g,
                          dtype=torch.int32))


@pytest.mark.parametrize("n,truncated", [(4, True), (8, True), (17, True),
                                         (32, True), (8, False), (24, False)])
@pytest.mark.parametrize("B", [1000, 4096, 4096 + 77])
def test_online_mul_kernel_bit_identical(cuda, n, truncated, B):
    # 1000 and 4096 + 77 end in a part-filled block of the kernel's 128 rows
    cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
    x, y = _digits(cuda, (B, n), n)
    before = mul_kernel.launches
    z, z_int = online_mul(x, y, cfg)
    assert mul_kernel.launches == before + 1
    want, want_int = online_mul_batch_ref(x, y, n=n, truncated=truncated,
                                          tail_gating=truncated)
    assert torch.equal(z, want) and torch.equal(z_int, want_int)


@pytest.mark.parametrize("K", [1, 3, 16, 33, 64, 256, 1000, 1024])
@pytest.mark.parametrize("n", [8, 13, 32])
@pytest.mark.parametrize("B", [37, 4096 - 37])
def test_online_dot_kernel_bit_identical(cuda, K, n, B):
    # 37 and 4096 - 37 rows end in a part-filled group and leave some
    # persistent blocks a group fewer than others
    cfg = OnlinePrecision(n=n)
    x, y = _digits(cuda, (B, K, n), K + n)
    before = dot_kernel.launches
    z, _ = online_dot(x, y, cfg)
    assert dot_kernel.launches == before + 1
    assert torch.equal(z, online_dot_batch_ref(x, y, n=n))


@pytest.mark.parametrize("K", [33, 256])
def test_online_dot_kernel_full_working_precision(cuda, K):
    cfg = OnlinePrecision(n=16, truncated=False, tail_gating=False)
    x, y = _digits(cuda, (4096 - 37, K, 16), K)
    z = dot_kernel.online_dot_kernel(x, y, cfg)
    assert torch.equal(z, online_dot_batch_ref(x, y, n=16, truncated=False,
                                               tail_gating=False))


@pytest.mark.parametrize("n", [16, 32])
def test_online_dot_kernel_reads_operands_at_a_4_byte_offset(cuda, n):
    # a base that is not 16-byte aligned takes the 4-byte copies
    x, y = _digits(cuda, (1000 * 33 * n + 1,), n)
    xo, yo = x[1:].view(1000, 33, n), y[:-1].view(1000, 33, n)
    assert xo.data_ptr() % 16 == 4
    z = dot_kernel.online_dot_kernel(xo, yo, OnlinePrecision(n=n))
    assert torch.equal(z, online_dot_batch_ref(xo, yo, n=n))


# Configurations past the unrolled kernels (delay other than 3, another
# estimate width, n past 32, a negative delay, an estimate wider than the
# datapath, the int64 lane) and K past 1024 lanes: the dispatch sends each
# to a kernel, which must give the plain version's digits.
GENERAL_CONFIGS = [dict(n=16, delta=4), dict(n=16, t=3),
                   dict(n=16, delta=2, t=1),
                   dict(n=16, delta=4, truncated=False, tail_gating=False),
                   dict(n=8, delta=0), dict(n=36), dict(n=40),
                   dict(n=8, delta=-1), dict(n=12, delta=-3, t=1),
                   dict(n=2, delta=0, t=5, truncated=False), dict(n=4, t=7),
                   dict(n=5, t=8), dict(n=16, t=-40), dict(n=24, t=1),
                   dict(n=16, t=1),
                   # F6: int64 lanes where the residual leaves int32
                   dict(n=24, delta=2, t=4), dict(n=28, delta=2, t=4),
                   dict(n=24, delta=3, t=4)]
DOT_CONFIGS = GENERAL_CONFIGS[:5] + GENERAL_CONFIGS[7:]


def _ids(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", GENERAL_CONFIGS, ids=_ids)
@pytest.mark.parametrize("B", [37, 4096 + 77])
def test_online_mul_kernel_at_every_configuration(cuda, kw, B):
    cfg = OnlinePrecision(**kw)
    x, y = _digits(cuda, (B, cfg.n), cfg.n)
    before = mul_kernel.launches
    z, z_int = online_mul(x, y, cfg)
    assert mul_kernel.launches == before + 1
    want, want_int = online_mul_batch_ref(
        x, y, n=cfg.n, delta=cfg.delta, t=cfg.t, truncated=cfg.truncated,
        tail_gating=cfg.tail_gating)
    assert torch.equal(z, want) and torch.equal(z_int, want_int)


@pytest.mark.parametrize("kw", DOT_CONFIGS, ids=_ids)
@pytest.mark.parametrize("K", [1, 3, 33, 256, 300, 2048])
def test_online_dot_kernel_at_every_configuration(cuda, kw, K):
    cfg = OnlinePrecision(**kw)
    x, y = _digits(cuda, (37, K, cfg.n), K)
    before = dot_kernel.launches
    z, _ = online_dot(x, y, cfg)
    assert dot_kernel.launches == before + 1
    assert torch.equal(z, online_dot_batch_ref(
        x, y, n=cfg.n, delta=cfg.delta, t=cfg.t, truncated=cfg.truncated,
        tail_gating=cfg.tail_gating))


@pytest.mark.parametrize("K,n", [(1025, 16), (2048, 16), (5000, 8),
                                 (70000, 8), (1500, 32), (300, 36),
                                 ((1 << 16) + 1, 32), (5000, 40)])
def test_online_dot_kernel_past_1024_lanes(cuda, K, n):
    # aligned subtrees of 256 lanes merged as a binary counter carries:
    # ragged last chunks, every chunk real (2^L lanes) and streams in 32,
    # 64 and 128 bits (n = 32 at K = 1500: 32 + 2 * 11 = 54 digits; at
    # K = 2^16 + 1: 66; n = 40 at K = 5000: 66)
    cfg = OnlinePrecision(n=n)
    B = 3 if K > 4096 else 21
    x, y = _digits(cuda, (B, K, n), K)
    before = dot_kernel.launches
    z, _ = online_dot(x, y, cfg)
    assert dot_kernel.launches == before + 1
    assert torch.equal(z, online_dot_batch_ref(x, y, n=n, delta=cfg.delta,
                                               t=cfg.t))


@pytest.mark.parametrize("kw", [dict(n=36, delta=1), dict(n=32, t=1)],
                         ids=_ids)
def test_a_configuration_no_kernel_holds_raises(cuda, kw):
    # the selection does not bound the residual and its bound leaves
    # int64: a CUDA operand raises before any launch, with no plain
    # version on the card
    cfg = OnlinePrecision(**kw)
    x, y = _digits(cuda, (37, 4, cfg.n), 4)
    before = (mul_kernel.launches, dot_kernel.launches)
    with pytest.raises(ValueError, match="does not bound the residual"):
        online_mul(x[:, 0].contiguous(), y[:, 0].contiguous(), cfg)
    with pytest.raises(ValueError, match="does not bound the residual"):
        online_dot(x, y, cfg)
    assert (mul_kernel.launches, dot_kernel.launches) == before


def test_online_dot_plan_knows_the_kernels_shared_memory(cuda):
    # launch_plan counts shared memory the way csrc/online_dot.cu does; the
    # kernel reports its own, and an SM holds at least one such block
    for n in range(4, 33):
        for vec in ((False, True) if n % 4 == 0 else (False,)):
            for K in (1, 2, 3, 16, 33, 64, 200, 256, 257, 1024):
                plan = dot_kernel.launch_plan(4096, K, n, vec)
                smem, blocks = dot_kernel.geometry(n, vec, plan.rows,
                                                   tree_levels(K))
                assert smem == plan.smem, (n, vec, K)
                assert blocks >= 1, (n, vec, K)


@pytest.mark.parametrize("n_bits,mode", [(16, "nbit"), (8, "nbit"),
                                         (16, "full"), (16, "eq8")])
@pytest.mark.parametrize("shape", [
    (5, 70, 37), (40, 130, 70), (4, 2048, 512),
    (1, 70, 37), (16, 70, 37), (17, 70, 37),     # around the 16-row tile
    (4, 1, 37), (4, 31, 37), (4, 33, 37),        # K not whole 16-byte copies
    (4, 8192, 300), (33, 8192, 300),             # K split across blocks
    (5, 256, 13)])                               # N not a multiple of 8
def test_tpmm_kernel_bit_identical(cuda, n_bits, mode, shape):
    x, w = _operands(cuda, *shape)
    before = tpmm_kernel.launches
    got = tpmm(x, w, n_bits=n_bits, mode=mode)
    assert tpmm_kernel.launches == before + 1
    ap, sa = plane_decompose(x, num_planes=n_bits // 4, axis=1)
    bp, sb = plane_decompose(w, num_planes=n_bits // 4, axis=0)
    want = tpmm_ref(ap, bp, sa, sb, n_bits=n_bits, mode=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tpmm_split_plan_knows_the_kernels_tile(cuda):
    # split_plan counts output tiles with kernel.tile_shape, a copy of the
    # kernel's geometry the CPU can run; the kernel reports its own
    import ctypes
    lib = tpmm_kernel._lib()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    for D in range(1, 16):
        for M in (1, 4, 16, 17, 64):
            for levels in range(1, 2 * D):
                lib.tpmm_tile(D, M, levels, ctypes.byref(rows),
                              ctypes.byref(cols))
                assert (rows.value, cols.value) == tpmm_kernel.tile_shape(
                    M, D, levels), (D, M, levels)


@pytest.mark.parametrize("n_bits,mode", [(16, "nbit"), (16, "full"),
                                         (8, "eq8")])
def test_tpmm_kernel_reads_a_planes_at_an_odd_address(cuda, n_bits, mode):
    x, w = _operands(cuda, 5, 2048, 300)
    D = n_bits // 4
    ap, sa = plane_decompose(x, num_planes=D, axis=1)
    bp, sb = plane_decompose(w.t(), num_planes=D, axis=1)
    odd = torch.empty(ap.numel() + 1, dtype=torch.int8,
                      device=cuda)[1:].view(ap.shape)
    odd.copy_(ap)
    assert odd.data_ptr() % 2 == 1
    bt = bp.transpose(1, 2)
    got = tpmm_kernel.tpmm_kernel(odd, bt, sa, sb.reshape(1, -1),
                                  n_bits=n_bits, mode=mode)
    want = tpmm_ref(ap, bt, sa, sb.reshape(1, -1), n_bits=n_bits, mode=mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["olm16", "tpmm16"])
def test_model_prefill_on_card_matches_cpu(cuda, mode):
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"),
                              compute_dtype="float32", dot_mode=mode)
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
    for eng in (DotEngine(mode="olm16"), DotEngine(mode="tpmm16")):
        for a, b in ((x, w), (x, table.T)):
            want = eng.dot(a, b)
            got = eng.dot(a.to(cuda), b.to(cuda))
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.cpu().view(torch.int16),
                               want.view(torch.int16))


RECURRENTGEMMA_KN = [(4096, 4096), (4096, 256), (4096, 12288), (12288, 4096),
                     (4096, 256000)]


@pytest.mark.parametrize("M", [4, 7])
@pytest.mark.parametrize("K,N", RECURRENTGEMMA_KN)
def test_kernel_at_recurrentgemma_shapes(cuda, M, K, N):
    # RecurrentGemma-9B's eng.dot GEMMs at a decode and a ragged
    # exact-length prefill; the 256000-wide head on its first and last
    # 2048 columns (an output's bits depend on its own column alone)
    x, w = _operands(cuda, M, K, N, seed=K + N)
    got = olm_matmul(x, w, n_bits=16)
    spans = [(0, N)] if N <= 32768 else [(0, 2048), (N - 2048, N)]
    for a, b in spans:
        want = olm_matmul_ref(x, w[:, a:b], n_bits=16)
        assert torch.equal(got[:, a:b].contiguous().view(torch.int32),
                           want.view(torch.int32))


def test_mamba2_decode_after_prefill_matches_forward_on_card(cuda):
    # the SSD stack on the card: a prefill, then one decode step, against
    # forward over the same tokens (bf16 compute, K1 at every eng.dot)
    cfg = dataclasses.replace(smoke_config("mamba2_130m"), dot_mode="olm16")
    model = Model(cfg, device=cuda)
    params = model.init(seed=0)
    toks = torch.randint(0, 512, (2, 12), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    full, _ = model.forward(params, {"tokens": toks})
    lg, cache, _ = model.prefill(params, {"tokens": toks[:, :11]},
                                 model.init_cache(2, 16))
    dec, _ = model.decode_step(params, toks[:, 11],
                               torch.full((2,), 11, device=cuda), cache)
    scale = float(full.abs().max())
    assert float((lg - full[:, 10]).abs().max()) / scale <= 3e-2
    assert float((dec - full[:, 11]).abs().max()) / scale <= 3e-2


# The autotuner (K1/K2's launch plans) and the enc-dec / VLM families.

@pytest.mark.parametrize("M,K,N", [(4, 2048, 8192), (64, 2048, 2048),
                                   (4, 8192, 2048)])
def test_every_tuner_candidate_gives_the_heuristics_bits(cuda, M, K, N):
    from repro_torch.kernels.online_dot import tuning
    x, w = _operands(cuda, M, K, N, seed=M + K)
    base = tuning.heuristic_tiling(M, N, K, 16)
    want = olm_matmul(x, w, n_bits=16, block_m=base.block_m,
                      block_n=base.block_n, tb=base.tb)
    assert torch.equal(want.view(torch.int32),
                       olm_matmul(x, w, n_bits=16).view(torch.int32))
    cands = tuning._candidates(M, N, K, 16, on_card=True)
    assert base in cands and len(cands) >= 4
    for c in cands:
        got = olm_matmul(x, w, n_bits=16, k_tile=c.k_tile, block_m=c.block_m,
                         block_n=c.block_n, tb=c.tb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), c


def _planned(monkeypatch):
    plans = []
    real = matmul_kernel.launch_plan

    def spy(*a, **kw):
        plans.append(real(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(matmul_kernel, "launch_plan", spy)
    return plans


def test_pinned_blocks_launch_the_plan_they_name(cuda, monkeypatch):
    plans = _planned(monkeypatch)
    x, w = _operands(cuda, 6, 48, 40)
    want = olm_matmul_ref(x, w, n_bits=16)
    got = DotEngine(mode="olm16", block_m=2, block_n=16).dot(x, w)
    assert (plans[-1].bm, plans[-1].bn) == (2, 16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got = olm_matmul(x, w, n_bits=16, quantize="host", block_m=2, block_n=4,
                     tb=8)
    assert (plans[-1].bm, plans[-1].bn, plans[-1].tb) == (2, 4, 8)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_host_kernel_replans_a_plan_that_misses_its_stage(cuda, monkeypatch):
    # 1 x 1 x 256 fits K1's stage and not K2's at n = 32: K2 takes the
    # planner's own plan, never the pinned one
    plans = _planned(monkeypatch)
    x, w = _operands(cuda, 3, 4096, 5)
    got = olm_matmul(x, w, n_bits=32, quantize="host", block_m=1, block_n=1,
                     tb=256)
    used = plans[-1]
    monkeypatch.undo()
    assert (used.bm, used.bn, used.tb) != (1, 1, 256)
    free = [matmul_kernel.launch_plan(3, 5, 4096, 32, host=True, vec=v)
            for v in (False, True)]
    assert (used.bm, used.bn, used.tb) in {(f.bm, f.bn, f.tb) for f in free}
    want = olm_matmul_ref(x, w, n_bits=32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_tune_writes_an_entry_named_for_the_card(cuda, tmp_path):
    import json

    from repro_torch.kernels.online_dot import tuning
    path = str(tmp_path / "t.json")
    cache = tuning.TuningCache(path)
    best = tuning.tune(64, 256, 512, 16, cache)
    data = json.loads(open(path).read())
    assert data["card"]["name"] == torch.cuda.get_device_name(cuda)
    assert data["card"]["sms"] == torch.cuda.get_device_properties(
        cuda).multi_processor_count
    entry = data["entries"][tuning.bucket_key(64, 256, 512, 16)]
    assert entry["source"] == "measured" and entry["us"] > 0
    assert tuning.get_tiling(64, 256, 512, 16, tuning.TuningCache(path)) \
        == best.as_dict()


@pytest.mark.parametrize("arch", ["llama_3_2_vision_11b",
                                  "seamless_m4t_medium"])
def test_cross_attention_model_on_card_matches_cpu(cuda, arch):
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                              dot_mode="olm16")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(seed=0)
    gpu = Model(cfg, device=cuda)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    gparams = to(params)
    g = torch.Generator().manual_seed(0)
    key = "frames" if cfg.family == "encdec" else "patches"
    batch = {"tokens": torch.randint(0, 512, (2, 6), generator=g),
             key: torch.randn(2, cfg.n_frontend_tokens, cfg.d_model,
                              generator=g)}
    want, _, wmem = cpu.prefill(params, batch, cpu.init_cache(2, 8))
    got, cache, mem = gpu.prefill(gparams, batch, gpu.init_cache(2, 8))
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-3
    assert float((mem.cpu() - wmem).abs().max() / wmem.abs().max()) <= 1e-3
    tok = batch["tokens"][:, -1]
    pos = torch.full((2,), 6)
    want, _ = cpu.decode_step(params, tok, pos, cpu.init_cache(2, 8), wmem)
    got, _ = gpu.decode_step(gparams, tok, pos, gpu.init_cache(2, 8), mem)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-3


@pytest.mark.parametrize("remat", ["none", "block"])
def test_olm16_train_step_launches_k1_and_gets_zero_grads(cuda, remat):
    # every GEMM of the forward through K1 (and, under remat, each
    # checkpointed layer's GEMMs but its last again in the backward); the
    # digit GEMMs' derivative is zero, so the moments stay zero
    from repro_torch.distributed.train import (build_train_step,
                                               init_train_state)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), remat=remat)
    model = Model(cfg, DotEngine(mode="olm16"), device=cuda)
    state = init_train_state(model, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = matmul_kernel.launches
    state, met = build_train_step(model)(state, {"tokens": toks})
    torch.cuda.synchronize()
    per_layer = 7
    gemms = cfg.n_layers * per_layer + 1
    if remat == "block":
        gemms += cfg.n_layers * (per_layer - 1)
    assert matmul_kernel.launches - before == gemms
    assert float(met["grad_norm"]) == 0.0
    assert not any(bool(t.any()) for t in tree_leaves(
        (state["opt"]["m"], state["opt"]["v"])))


def test_native_train_step_on_card_matches_cpu(cuda):
    from repro_torch.distributed.train import (build_train_step,
                                               init_train_state)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"),
                              compute_dtype="float32")
    cpu = Model(cfg, device="cpu")
    card = Model(cfg, device=cuda)
    s_cpu = init_train_state(cpu, seed=0)
    s_cpu["opt"]["step"].fill_(50)         # a learning rate above zero
    s_card = tree_map(lambda t: t.to(cuda), s_cpu)
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(2))
    opt = AdamWConfig(lr=1e-4)
    s_cpu, m_cpu = build_train_step(cpu, opt_cfg=opt)(s_cpu, {"tokens": toks})
    s_card, m_card = build_train_step(card, opt_cfg=opt)(
        s_card, {"tokens": toks.to(cuda)})
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-4 * max(
            abs(float(m_cpu[k])), 1e-30), k
    for a, b in zip(tree_leaves(s_card["params"]),
                    tree_leaves(s_cpu["params"])):
        err = (a.cpu() - b).abs().max() / b.abs().max()
        assert float(err) <= 1e-4


# The shard phase's (a) of chip_smoke.py: InternLM2-1.8B's wq, wg, wd and
# head at 64 rows, olm16 (and wq under olm32t16), each partitioned m, n
# and k over a (1, 2) mesh of two ranks that share the card (a gloo group
# on 127.0.0.1; NCCL refuses two ranks on one device).
SHARD_GEMMS = (((2048, 2048), 16, None), ((2048, 8192), 16, None),
               ((8192, 2048), 16, None), ((2048, 92544), 16, None),
               ((2048, 2048), 32, 16))


def _sharded_gemm_rank(rank, world, port, out_dir):
    import json
    import os

    import torch.distributed as dist
    from repro_torch.kernels.online_dot.matmul import olm_error_bound
    from repro_torch.kernels.online_dot.matmul_sharded import (
        olm_matmul_sharded)
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_local_mesh(1, world, device_type="cuda")
        for (K, N), n, p in SHARD_GEMMS:
            x, w = _operands(dev, 64, K, N, seed=K + N)
            single = olm_matmul(x, w, n_bits=n, trunc=p)
            exact = x.double() @ w.double()
            lim = olm_error_bound(x, w, n_bits=n, trunc=p).double()
            for part in ("m", "n", "k"):
                before = matmul_kernel.launches
                got = olm_matmul_sharded(x, w, mesh=mesh, partition=part,
                                         n_bits=n, trunc=p)
                torch.cuda.synchronize()
                ok = (torch.equal(got.view(torch.int32),
                                  single.view(torch.int32))
                      if part != "k" else
                      bool(((got.double() - exact).abs() <= lim).all()))
                out[f"{K}x{N} n{n} t{p} {part}"] = [
                    ok, matmul_kernel.launches - before]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_sharded_gemms_over_two_ranks_on_the_card(cuda, tmp_path):
    import json
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_sharded_gemm_rank, args=(2, port, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(res) == 3 * len(SHARD_GEMMS)
        # m/n bit-identical and k within the bound; one K1 launch a call
        assert all(v == [True, 1] for v in res.values()), (r, res)
