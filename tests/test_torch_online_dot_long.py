"""K3 past 1024 lanes a row, on the CPU: the route, the host's plan and the
kernels' reduction order.

Past MAX_LANES lanes a row, csrc/online_dot.cu cuts each row into aligned
subtrees of 1024 lanes (the reference tree's level-10 nodes), one a group,
and the block that finishes a row's last subtree merges the row's level-10
streams level by level in scratch, in place, a chunk of 256 pairs at a
time. These tests hold `kernel.route` to the kernel each configuration
runs, `kernel.launch_plan` to running every row and lane once in subtrees
aligned to the reference's tree, and a replay of the in-place merge to
the reference's adder tree; the plain version equals the reference's
Pallas kernel (interpret mode) past 1024 lanes. The kernels themselves run
only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels.online_dot.kernel import online_dot_pallas
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import kernel as k3
from repro_torch.kernels.online_dot.ref import (adder_tree,
                                                online_dot_batch_ref,
                                                tree_levels)

RAGGED_B = (1, 37, 4096 - 37, 4096 + 77)
LONG_KS = (1025, 2047, 2048, 4097, 65537)
THREADS = 256                    # online_dot.cu kThreads: a merge chunk


@pytest.mark.parametrize("kw,K,route", [
    (dict(n=16), 1025, "unrolled"),
    (dict(n=16), 2048, "unrolled"),          # InternLM2-1.8B's d_model
    (dict(n=16), 8192, "unrolled"),          # and its d_ff
    (dict(n=32), 8192, "unrolled"),          # 32 + 26 digits
    (dict(n=32), 1 << 16, "unrolled"),       # 32 + 32: the widest
    (dict(n=32), (1 << 16) + 1, "any"),      # 32 + 34: 128-bit words
    (dict(n=4), 1 << 30, "unrolled"),
    (dict(n=16, t=3), 4096, "unrolled"),     # another t the int32 lane holds
    (dict(n=16, delta=4), 4096, "any"),
    (dict(n=16, t=1), 4096, "any"),          # the int64 lane
    (dict(n=36), 4096, "any"),
    (dict(n=24, delta=2, t=4), 2048, "any"),  # F6
])
def test_route_sends_long_rows_to_the_kernel_that_runs_them(kw, K, route):
    cfg = OnlinePrecision(**kw)
    assert k3.holds(cfg, K) and k3.route(cfg, K) == route
    # the route's plan builds: the unrolled kernel's streams fit 64 bits
    n = cfg.n
    general = route == "any"
    plan = k3.launch_plan(37, K, n, n % 4 == 0, general=general)
    assert plan.trees == -(-K // k3.MAX_LANES)
    assert n + 2 * tree_levels(K) <= (128 if general else 64)


@pytest.mark.parametrize("K", LONG_KS)
@pytest.mark.parametrize("B", RAGGED_B)
def test_long_plan_runs_every_row_and_lane_once(B, K):
    for n, general in ((16, False), (32, True)):
        for per_sm in (None, 1):
            plan = k3.launch_plan(B, K, n, True, sms=132,
                                  blocks_per_sm=per_sm, general=general)
            assert plan.rows == 1 and plan.subs == 4
            assert plan.trees == -(-K // k3.MAX_LANES)
            assert plan.groups == B * plan.trees
            by_row = {}
            for b in range(plan.grid):
                got = plan.lanes_of(b, B, K)
                assert got, b                # every block has work
                for row, lanes in got:
                    # a group is one aligned subtree: a level-10 node
                    assert lanes.start % k3.MAX_LANES == 0
                    assert len(lanes) == min(k3.MAX_LANES,
                                             K - lanes.start) > 0
                    by_row.setdefault(row, []).append(lanes)
            assert sorted(by_row) == list(range(B))
            for row, spans in by_row.items():
                spans.sort(key=lambda r: r.start)
                assert spans[0].start == 0 and spans[-1].stop == K
                assert all(a.stop == b.start for a, b in zip(spans, spans[1:]))
            fit = min(k3.BLOCKS_PER_SM,
                      k3.SMEM_PER_SM // (plan.smem + k3.SMEM_RESERVED))
            per = fit if per_sm is None else min(fit, per_sm)
            runs = k3.balanced_blocks(plan.groups, 132, per)
            assert plan.grid == min(plan.groups, 132 * runs)


def test_short_plans_run_every_row_and_lane_once():
    # up to 1024 lanes a group holds whole rows, every lane of each
    for K in (1, 3, 256, 1000, 1024):
        for general in (False, True):
            plan = k3.launch_plan(4096 + 77, K, 8, True, general=general)
            seen = [(r, tuple(lanes)) for b in range(plan.grid)
                    for r, lanes in plan.lanes_of(b, 4096 + 77, K)]
            assert plan.trees == 1
            assert sorted(seen) == [(r, tuple(range(K)))
                                    for r in range(4096 + 77)]


def test_long_plans_fit_shared_memory():
    for n in range(4, 33):
        for vec in ((False, True) if n % 4 == 0 else (False,)):
            for K in (1025, 2048, 8192, 1 << 16):
                if n + 2 * tree_levels(K) > 64:
                    continue
                plan = k3.launch_plan(512, K, n, vec)
                word = 4 if n + 2 * tree_levels(K) <= 32 else 8
                # a subtree's 1024 level-0 streams in 32-bit words, its 8
                # level-7 nodes in the row's stream word
                assert plan.smem == (8 * 256 * k3.row_words(n, vec)
                                     + 2 * 4 * 1024 + 2 * word * 8)
                assert plan.smem + k3.SMEM_RESERVED <= k3.SMEM_PER_SM
    for n in range(1, 65):
        for vec in ((False, True) if n % 4 == 0 else (False,)):
            for K in (1, 3, 1024, 1025, 1 << 20):
                if n + 2 * tree_levels(K) > 128:
                    continue
                plan = k3.launch_plan(512, K, n, vec, general=True)
                assert plan.smem <= k3.SMEM_PER_BLOCK, (n, vec, K)
                assert plan.smem % 16 == 0
                assert plan.rows << min(tree_levels(K), 10) <= 2048


def _add(a, b):
    return adder_tree(torch.stack([a, b]))[0]


def _merge_in_place(nodes, K):
    """csrc/online_dot.cu `merge_trees`, step for step: a row's level-10
    streams merged in place, a chunk of 256 pairs at a time (every pair of
    the chunk read, then every parent written), up to level L."""
    nodes = list(nodes)
    for l in range(10, tree_levels(K)):
        k = ((K - 1) >> l) + 1
        half = (k + 1) >> 1
        for base in range(0, half, THREADS):
            pairs = [(nodes[2 * i], nodes[2 * i + 1] if 2 * i + 1 < k
                      else torch.zeros_like(nodes[2 * i]))
                     for i in range(base, min(half, base + THREADS))]
            for i, (a, b) in enumerate(pairs, base):
                nodes[i] = _add(a, b)
    return nodes[0]


@pytest.mark.parametrize("trees", [2, 3, 5, 65, 700])
def test_in_place_merge_is_the_reference_tree_above_level_10(trees):
    # the level-10 nodes of a row of K lanes, as the subtrees leave them;
    # 700 of them take two chunks of 256 pairs at level 10
    rng = np.random.default_rng(trees)
    K = (trees - 1) * 1024 + 1 + int(rng.integers(0, 1024))
    assert -(-K // 1024) == trees
    m = 4 + 20
    nodes = [torch.from_numpy(rng.integers(-1, 2, m)).int()
             for _ in range(trees)]
    want, levels = adder_tree(torch.stack(nodes))
    assert levels == tree_levels(K) - 10
    assert torch.equal(_merge_in_place(nodes, K), want)


@pytest.mark.parametrize("K", [1025, 2047, 2048, 4097])
def test_subtrees_then_merge_is_the_reference_tree(K):
    # each aligned subtree of 1024 lanes reduced on its own (lanes past K
    # are zero streams), then merged: the reference's tree of the row
    rng = np.random.default_rng(K)
    lanes = torch.from_numpy(rng.integers(-1, 2, (K, 5))).int()
    subs = []
    for c in range(-(-K // 1024)):
        sub = lanes[c * 1024:(c + 1) * 1024]
        sub = torch.cat([sub, sub.new_zeros(1024 - len(sub), 5)])
        subs.append(adder_tree(sub)[0])
    assert torch.equal(_merge_in_place(subs, K), adder_tree(lanes)[0])


def test_plain_version_is_the_tpu_kernel_past_1024_lanes():
    rng = np.random.default_rng(1025)
    xd = rng.integers(-1, 2, (2, 1025, 8)).astype(np.int32)
    yd = rng.integers(-1, 2, (2, 1025, 8)).astype(np.int32)
    want = online_dot_pallas(xd, yd, n=8, block_b=2, interpret=True)
    got = online_dot_batch_ref(torch.from_numpy(xd), torch.from_numpy(yd),
                               n=8)
    assert got.shape == (2, 8 + 2 * 11)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_field_packing_multiply_gives_each_digits_twos_complement():
    # olm_lane.cuh `pack_fields`: four digit words' low bytes gathered into
    # one word (digit i in byte i), masked to two bits a byte and moved by
    # one multiply into a byte with digit 0 on top; each 2-bit field,
    # shifted arithmetically, reads back as its digit
    import itertools
    for digits in itertools.product((-1, 0, 1), repeat=4):
        g = sum((d & 0xFF) << (8 * i) for i, d in enumerate(digits))
        b = (((g & 0x03030303) * 0x40100401) & 0xFFFFFFFF) >> 24
        for i, d in enumerate(digits):
            field = (b >> (6 - 2 * i)) & 3
            assert field == d & 3
            assert (field - 4 if field & 2 else field) == d


@pytest.mark.parametrize("n,delta", [(16, 3), (16, 4), (8, 0), (8, -1),
                                     (12, -3), (32, 2), (2, 0), (5, 3)])
def test_msd_first_output_bits_reversed_land_at_their_digit(n, delta):
    # lane_gen shifts each selection step's +1 and -1 bits in from the
    # bottom (step s = j + delta makes digit j), then reverses the word
    # and shifts right by 32 - n: digit j lands at bit j, and the digits
    # before the first selected one (a negative delay) stay 0
    rng = np.random.default_rng(n * 10 + delta + 50)
    ups = rng.integers(0, 2, n)
    steps, lead = n + delta, min(max(delta, 0), n + delta)
    op = 0
    for s in range(lead, steps):
        op = ((op << 1) | int(ups[s - delta])) & 0xFFFFFFFF
    rev = int(f"{op:032b}"[::-1], 2)
    got = rev >> (32 - n)
    for j in range(n):
        want = int(ups[j]) if j >= max(0, -delta) else 0
        assert (got >> j) & 1 == want, j
