"""Which kernel the digit-level API sends a configuration to, decided from
the configuration before any launch; a replay on the CPU of the general
kernel's lane (csrc/olm_digits.cuh `lane_any`, in its int32 or int64
datapath, with the shifts the plain version takes past the word spelt
out) against the plain version; and a replay of the general K3 kernel's
reduction order (csrc/online_dot.cu `online_dot_any`: aligned subtrees of
256 lanes, then a binary-counter merge of their streams) against the
reference's adder tree.

The kernels themselves run only on the card: their bit-equality tests are
in tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from repro.core.precision import OnlinePrecision as JPrecision
from repro.kernels.online_dot.ops import online_dot as jonline_dot
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import kernel as dot_kernel
from repro_torch.kernels.online_dot.ops import online_dot
from repro_torch.kernels.online_dot.ops import runs_kernel as dot_runs
from repro_torch.kernels.common import (checked_schedule, prove_schedule,
                                        resolve_use_pallas)
from repro_torch.kernels.online_dot.ref import adder_tree, tree_levels
from repro_torch.kernels.online_mul import kernel as mul_kernel
from repro_torch.kernels.online_mul.ops import online_mul
from repro_torch.kernels.online_mul.ops import runs_kernel as mul_runs
from repro_torch.kernels.online_mul.ref import online_mul_batch_ref

CHUNK_LEVELS = 8                   # online_dot.cu kChunkLevels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw,K,route", [
    (dict(n=16), 2048, "any"),
    (dict(n=16), 1025, "any"),
    (dict(n=16), 1024, "unrolled"),
    (dict(n=16, delta=4), 16, "any"),
    (dict(n=16, t=3), 16, "unrolled"),
    (dict(n=16, delta=4, t=3), 2048, "any"),
    (dict(n=36), 300, "any"),
    (dict(n=16), (1 << 24) + 1, "any"),     # a stream of 16 + 50 digits
    (dict(n=32), (1 << 16) + 1, "any"),     # 32 + 34
    (dict(n=8, delta=-1), 8, "any"),        # a negative delay
    (dict(n=2, delta=0, t=5, truncated=False), 8, "any"),   # S < t
    (dict(n=24, t=1), 8, "any"),            # the int64 lane
    (dict(n=16, t=1), 8, "any"),            # delta 3, but the int64 lane
])
def test_dispatch_sends_the_configuration_to_a_kernel(kw, K, route):
    cfg = OnlinePrecision(**kw)
    assert dot_runs(cfg, K) and dot_kernel.route(cfg, K) == route
    assert mul_runs(cfg)
    assert mul_kernel.route(cfg) == ("unrolled" if (cfg.delta, cfg.t)
                                     == (3, 2) and cfg.n <= 32 else "any")
    # use_pallas=False still asks for the plain version
    assert not dot_runs(cfg, K, use_pallas=False)
    assert not mul_runs(cfg, use_pallas=False)


@pytest.mark.parametrize("kw,K", [
    (dict(n=36, delta=1), 8),          # the residual's bound leaves int64
    (dict(n=32, delta=1), 8),
    (dict(n=32, t=1), 8),
    (dict(n=32, delta=2, t=5), 8),     # F6: int32 not proven, int64 neither
    (dict(n=16), 1 << 57),             # a stream of 16 + 114 digits
])
def test_cases_outside_the_kernels_are_decided_before_any_launch(kw, K):
    # the reference's dispatch sends each to its kernel, so a CUDA operand
    # goes to the kernel's wrapper (resolve_use_pallas), which raises
    # before any launch: check_config or the stream's width decide it
    cfg = OnlinePrecision(**kw)
    assert resolve_use_pallas(cfg, None)
    assert not dot_runs(cfg, K) and not dot_kernel.holds(cfg, K)
    if K < 1 << 57:
        assert not mul_runs(cfg) and not mul_kernel.holds(cfg)
        with pytest.raises(ValueError, match="does not bound the residual"):
            mul_kernel.check_config(cfg)
    else:
        assert mul_runs(cfg)


def _wrap(v, bits):
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _lane_any(x, y, cfg, sched, S, bits):
    """csrc/olm_digits.cuh `lane_any` at a `bits`-bit datapath, step for
    step: the host's constants (`step_consts`, kernel.launch_any's lift),
    the sign-filling shifts it spells out, and the word's wrap (the peak
    |value| of the registers X and Y, the term, V and W is returned
    too)."""
    n, delta, t = cfg.n, cfg.delta, cfg.t
    top = bits - 1
    shift = min(S - t, top)
    lift = 0 if t > n + delta else 1 << min(max(t - S, 0), 2)
    X = Y = W = peak = 0
    z = [0] * n
    for s in range(n + delta):
        T, q, j = int(sched[s]), s + 1, s - delta
        keep = _wrap(0xFFFFFFFF << max(S - T, 0), 32)
        wq = 1 << max(S - q, 0) if q <= min(T, S) else 0
        xd, yd = (int(x[s]), int(y[s])) if s < n else (0, 0)
        Yf = _wrap(Y + yd * wq, bits)
        term = _wrap(X * yd + Yf * xd, bits)
        append = (term >> delta if delta >= 0 else term >> top) & keep
        peak = max(peak, abs(X * yd + Yf * xd), abs(X + xd * wq), abs(Yf),
                   abs(2 * W + append))
        X = _wrap(X + xd * wq, bits) & keep
        Y = Yf & keep
        V = _wrap(2 * W + append, bits)
        if j >= 0:
            vq = V >> shift if shift >= 0 else max(-2, min(V, 2)) * lift
            zj = 1 if vq >= 2 else (0 if vq >= -2 else -1)
            W = _wrap(V - zj * (1 << S), bits) & keep
            z[j] = zj
        else:
            W = V & keep
        peak = max(peak, abs(W))
    return z, peak


LANE_CONFIGS = [dict(n=16), dict(n=16, delta=4), dict(n=16, t=3),
                dict(n=8, delta=-1), dict(n=12, delta=-3, t=1),
                dict(n=2, delta=0, t=5, truncated=False), dict(n=4, t=7),
                dict(n=5, t=8), dict(n=8, t=-3), dict(n=16, t=-40),
                dict(n=16, delta=2, t=1), dict(n=8, delta=0),
                dict(n=24, t=1), dict(n=16, t=1),
                # F6: the selection condition holds, but the residual
                # grows past int32 (the first two) or the prover cannot
                # show it does not (the third): all three run in the
                # 64-bit lane
                dict(n=24, delta=2, t=4), dict(n=28, delta=2, t=4),
                dict(n=24, delta=3, t=4)]


@pytest.mark.parametrize("kw", LANE_CONFIGS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_general_lane_replay_matches_the_plain_version(kw):
    # the general kernel's lane, in the datapath lane_bits picks, gives
    # the plain version's digits, also where a shift passes the word, and
    # stays inside the sound bound recurrence_peak computes
    cfg = OnlinePrecision(**kw)
    sched, S = checked_schedule(cfg)
    bits = mul_kernel.lane_bits(cfg, sched, S)
    bound = mul_kernel.recurrence_peak(cfg, sched, S)
    rng = np.random.default_rng(cfg.n * 7 + cfg.delta)
    x = rng.integers(-1, 2, (150, cfg.n))
    y = rng.integers(-1, 2, (150, cfg.n))
    x[0] = y[0] = 1                    # the largest product
    want, _ = online_mul_batch_ref(torch.from_numpy(x), torch.from_numpy(y),
                                   **kw)
    lanes = [_lane_any(a, b, cfg, sched, S, bits) for a, b in zip(x, y)]
    assert np.array_equal(np.array([z for z, _ in lanes]), want.numpy())
    assert max(p for _, p in lanes) <= bound


@pytest.mark.parametrize("delta", [1, 2, 3, 4, 5])
def test_the_int32_lane_is_proven_by_the_overflow_prover(delta):
    # F6: lane_bits picks 32 bits only where the prover's walk of the
    # recurrence shows every value within 31 bits, and that walk is sound:
    # the exact replay (a 64-bit datapath, which these values cannot
    # leave) of random, all-ones and alternating lanes of every such
    # configuration stays inside the bits it proves
    rng = np.random.default_rng(delta)
    proven = 0
    for n in range(max(4, delta + 1), 33):
        ones = np.ones(n, np.int64)
        alt = np.resize(np.array([1, -1], np.int64), n)
        for t in range(1, 6):
            cfg = OnlinePrecision(n=n, delta=delta, t=t)
            sched, S = checked_schedule(cfg)
            if mul_kernel.lane_bits(cfg, sched, S) != 32:
                continue
            bits = prove_schedule(cfg)[0]
            assert bits <= 31, (n, delta, t)
            pairs = [(ones, ones), (ones, -ones), (alt, alt), (alt, ones),
                     *zip(rng.integers(-1, 2, (96, n)),
                          rng.integers(-1, 2, (96, n)))]
            peak = max(_lane_any(a, b, cfg, sched, S, 64)[1]
                       for a, b in pairs)
            assert peak < 1 << bits <= 1 << 31, (n, delta, t, peak, bits)
            proven += 1
    # a delay of 1 never runs in int32; the others do at some n and t
    assert (proven == 0) == (delta == 1)


@pytest.mark.parametrize("truncated", [True, False])
def test_the_papers_configuration_runs_in_int32(truncated):
    # the unrolled kernels' premise: at delay 3 and t = 2 the selection
    # bounds the residual at every n whose schedule fits int32
    for n in range(4, 56):
        cfg = OnlinePrecision(n=n, truncated=truncated)
        try:
            sched, S = checked_schedule(cfg)
        except ValueError:
            continue
        assert mul_kernel.lane_bits(cfg, sched, S) == 32


@pytest.mark.parametrize("kw,K", [(dict(n=8), 2048), (dict(n=8, delta=4), 5),
                                  (dict(n=8, t=3), 7)])
def test_cpu_operands_match_the_reference_and_never_launch(kw, K):
    # the plain version on the CPU gives the reference's digits for the
    # configurations that now run on a kernel on the card
    rng = np.random.default_rng(K)
    x = rng.integers(-1, 2, (3, K, kw["n"])).astype(np.int32)
    y = rng.integers(-1, 2, (3, K, kw["n"])).astype(np.int32)
    cfg = OnlinePrecision(**kw)
    before = (dot_kernel.launches, mul_kernel.launches)
    z, _ = online_dot(torch.from_numpy(x), torch.from_numpy(y), cfg)
    zm, _ = online_mul(torch.from_numpy(x[:, 0]), torch.from_numpy(y[:, 0]),
                       cfg)
    assert (dot_kernel.launches, mul_kernel.launches) == before
    jz, _ = jonline_dot(x, y, JPrecision(**kw), use_pallas=False)
    assert np.array_equal(z.numpy(), np.asarray(jz))
    want, _ = online_mul_batch_ref(torch.from_numpy(x[:, 0]),
                                   torch.from_numpy(y[:, 0]), **kw)
    assert torch.equal(zm, want)


def _add(a, b):
    return adder_tree(torch.stack([a, b]))[0]


def _kernel_order(streams):
    """online_dot_any's reduction of one row's (K, m) lane streams: lanes
    padded with zero streams to whole 256-lane chunks, each chunk reduced
    by the tree, the chunk streams merged as a binary counter carries,
    and what is left paired with zero streams up to level L."""
    K, m = streams.shape
    L = tree_levels(K)
    if L <= CHUNK_LEVELS:
        pad = streams.new_zeros((1 << L) - K, m)
        return adder_tree(torch.cat([streams, pad]))[0]
    C = 1 << CHUNK_LEVELS
    stack = {}
    for c in range(-(-K // C)):
        chunk = streams[c * C:(c + 1) * C]
        chunk = torch.cat([chunk, chunk.new_zeros(C - len(chunk), m)])
        v, lv = adder_tree(chunk)[0], CHUNK_LEVELS
        while lv in stack:
            v = _add(stack.pop(lv), v)
            lv += 1
        stack[lv] = v
    cur = None
    for lv in range(CHUNK_LEVELS, L):
        if cur is not None:
            zero = torch.zeros_like(cur)
            cur = _add(stack.pop(lv) if lv in stack else zero, cur)
        elif lv in stack:
            v = stack.pop(lv)
            cur = _add(v, torch.zeros_like(v))
    return stack.pop(L) if cur is None else cur


@pytest.mark.parametrize("K", [5, 200, 257, 300, 512, 1025, 2048, 3000])
def test_general_kernel_order_is_the_reference_tree(K):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-1, 2, (K, 8)).astype(np.int32))
    y = torch.from_numpy(rng.integers(-1, 2, (K, 8)).astype(np.int32))
    lanes, _ = online_mul_batch_ref(x, y, n=8)
    want, levels = adder_tree(lanes)
    got = _kernel_order(lanes)
    assert levels == tree_levels(K)
    assert torch.equal(got, want)
