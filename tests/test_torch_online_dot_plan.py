"""K3's host-side launch plan and its adder-tree schedule, on the CPU.

`kernel.launch_plan` is the part of `csrc/online_dot.cu`'s geometry the host
computes: rows a group, stages a group, shared memory a block and the
persistent grid. These tests hold it to what the kernel needs: every row
run exactly once for ragged B, stages that cover a group, shared memory
inside the 227 KB a block may ask for (and at least one block an SM) for
every n and K the kernel takes, and one wave of blocks. The kernel's tree
(warps of 128 level-0 nodes, two level-0 adders and their parent a thread,
register shuffles, one warp for the levels past 7) is replayed here step
for step on the reference's online adder and held to `adder_tree`, with
garbage wherever the kernel reads a node that is not real."""
import numpy as np
import pytest
import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.online_dot import kernel as k3
from repro_torch.kernels.online_dot.matmul_kernel import OPS_ADDER
from repro_torch.kernels.online_dot.ref import adder_tree, tree_levels

RAGGED_B = (1, 37, 4096 - 37, 4096 + 77)
KS = (1, 2, 3, 16, 33, 64, 255, 256, 257, 1000, 1024)


@pytest.mark.parametrize("B", RAGGED_B)
@pytest.mark.parametrize("K", KS)
def test_plan_runs_every_row_once(B, K):
    for n, vec in ((8, True), (13, False), (32, True)):
        for per_sm in (None, 1, 3):
            plan = k3.launch_plan(B, K, n, vec, sms=132,
                                  blocks_per_sm=per_sm)
            seen = [r for b in range(plan.grid) for rng in plan.rows_of(b, B)
                    for r in rng]
            assert sorted(seen) == list(range(B)), (n, per_sm)
            # every block has work, and the grid is one wave of the
            # blocks an SM runs (at most those it holds) that balance the
            # groups over the SMs
            assert all(plan.rows_of(b, B) for b in range(plan.grid))
            fit = min(k3.BLOCKS_PER_SM,
                      k3.SMEM_PER_SM // (plan.smem + k3.SMEM_RESERVED))
            per = fit if per_sm is None else min(fit, per_sm)
            runs = k3.balanced_blocks(plan.groups, 132, per)
            assert 1 <= runs <= per
            assert plan.grid == min(plan.groups, 132 * runs)


@pytest.mark.parametrize("groups,most,runs", [
    (1024, 5, 4),       # B=512 K=2048 n=16: 2 groups on 496 of 528 blocks
    (1024, 3, 2),       # B=512 K=2048 n=32
    (1024, 6, 4),       # B=4096 K=64 n=16
    (4096, 6, 5),       # B=4096 K=256 n=8 and 16
    (4096, 3, 3),       # B=4096 K=256 n=32
    (256, 6, 6),        # B=4096 K=16: one group a block on any count
    (1, 8, 8),
])
def test_balanced_blocks_spread_the_groups_over_the_sms(groups, most, runs):
    assert k3.balanced_blocks(groups, 132, most) == runs
    loads = [k3.sm_load(groups, 132, p) for p in range(1, most + 1)]
    # the count runs no SM more than 10% past the least load, and no
    # larger count does as well
    assert loads[runs - 1] <= k3.LOAD_SLACK * min(loads)
    assert all(load > k3.LOAD_SLACK * min(loads) for load in loads[runs:])
    # the load is an SM's blocks times its busiest block's groups
    grid = min(groups, 132 * runs)
    assert k3.sm_load(groups, 132, runs) >= groups / 132
    assert k3.sm_load(groups, 132, runs) == (-(-grid // 132)
                                              * -(-groups // grid))


@pytest.mark.parametrize("K", KS)
def test_plan_stages_cover_a_group(K):
    for B in RAGGED_B:
        plan = k3.launch_plan(B, K, 16, True)
        lanes = plan.rows * K
        assert (plan.subs - 1) * k3.THREADS < lanes <= plan.subs * k3.THREADS
        # the kernel's precondition: one stage of whole rows, or one row
        assert plan.subs == 1 or plan.rows == 1
        assert plan.rows == min(B, max(1, k3.THREADS // K))


def test_plan_fits_shared_memory_for_every_configuration():
    most = 0
    for n in range(4, 33):
        for vec in ((False, True) if n % 4 == 0 else (False,)):
            for K in range(1, k3.MAX_LANES + 1):
                plan = k3.launch_plan(4096, K, n, vec)
                assert plan.smem <= k3.SMEM_PER_BLOCK, (n, vec, K)
                assert plan.smem + k3.SMEM_RESERVED <= k3.SMEM_PER_SM
                assert plan.grid >= 1 and plan.smem % 16 == 0
                # csrc/online_dot.cu refuses more than 2048 tree nodes
                assert plan.rows << tree_levels(K) <= 2048
                most = max(most, plan.smem)
    assert most <= k3.SMEM_PER_BLOCK


def test_plan_shared_memory_by_n_and_k():
    # two operands of one 256-lane stage, then the tree's nodes: two masks
    # a level-0 node in the lane's 32-bit word (8 bytes), and the nodes
    # left after the warps' 7 levels (2^l >> 7 of them) in the row's
    # stream word, two masks each (8 bytes where the stream fits 32 bits,
    # else 16)
    assert k3.launch_plan(4096, 256, 32, True).smem == (2 * 256 * 128
                                                        + 8 * 256 + 16 * 2)
    assert k3.launch_plan(4096, 256, 16, True).smem == (2 * 256 * 64
                                                        + 8 * 256 + 8 * 2)
    assert k3.launch_plan(4096, 256, 8, True).smem == (2 * 256 * 32
                                                       + 8 * 256 + 8 * 2)
    assert k3.launch_plan(4096, 1024, 16, True).smem == (2 * 256 * 64
                                                         + 8 * 1024 + 16 * 8)
    # one lane a row parks no level-0 node: 256 rows' streams in the
    # stream word; a level of 2 lanes keeps its rows' streams
    assert k3.launch_plan(4096, 1, 16, True).smem == 2 * 256 * 64 + 8 * 256
    assert k3.launch_plan(4096, 2, 16, True).smem == (2 * 256 * 64 + 8 * 256
                                                      + 8 * 128)
    # n = 24 pads its 6 chunks to 7, n = 13 its 13 words to 13, 14 to 15
    assert k3.row_words(24, True) == 28
    assert k3.row_words(13, False) == 13 and k3.row_words(14, False) == 15
    # past MAX_LANES a group is one row's subtree of MAX_LANES lanes, its
    # nodes in words as wide as the row's stream (8 + 22 digits: 32 bits)
    assert k3.launch_plan(4096, k3.MAX_LANES + 1, 8, True).smem == (
        2 * 256 * 32 + 8 * 1024 + 8 * 8)
    # the unrolled kernel's streams end at 64 digits (n = 32 at 2^17 lanes
    # is 66); the general kernel's at 128
    with pytest.raises(ValueError):
        k3.launch_plan(4096, 1 << 17, 32, True)
    assert k3.launch_plan(4096, 1 << 17, 32, True, general=True).trees == 128


def test_tree_adders_are_the_reference_trees():
    for K in range(1, k3.MAX_LANES + 1):
        count, k = 0, K
        while k > 1:                 # adder_tree pads an odd level and pairs
            k += k % 2
            count += k // 2
            k //= 2
        assert k3.tree_adders(K) == count
    cfg = OnlinePrecision(n=16)
    lane = cfg.steps * 23 + 16 * (14 + 10)
    assert k3.int_ops(4096, 256, cfg) == 4096 * (256 * lane + 255 * OPS_ADDER
                                                 + (16 + 16) * 4)


def _add(a, b):
    """The reference's online adder on two streams."""
    return adder_tree(torch.stack([a, b]))[0]


def _kernel_tree(level0, K, rows, rng):
    """csrc/online_dot.cu's tree, step for step: `level0` holds the group's
    rows * 2^L level-0 nodes (node r * 2^L + k for lane k of row r, the
    rest not real). Returns each row's stream."""
    L = tree_levels(K)
    nodes = rows << L
    if L == 0:
        return level0[:rows]
    m0 = level0[0].numel()

    def junk(level):
        return torch.from_numpy(rng.integers(-1, 2, m0 + 2 * level)).int()

    def tree_add(left, right, a, l):
        i = a & ((1 << (L - 1 - l)) - 1)
        real = 2 * i + 1 < ((K - 1) >> l) + 1
        return _add(left, right if real else torch.zeros_like(right))

    lw = min(L, 7)
    out = nodes >> lw
    kept = {}
    for c in range(-(-nodes // 128)):
        v, w = [], []
        for lane in range(32):
            a = 64 * c + 2 * lane
            v.append(tree_add(level0[2 * a], level0[2 * a + 1], a, 0)
                     if 2 * a < nodes else torch.zeros(m0 + 2, dtype=torch.int32))
            w.append(tree_add(level0[2 * a + 2], level0[2 * a + 3], a + 1, 0)
                     if 2 * a + 2 < nodes
                     else torch.zeros(m0 + 2, dtype=torch.int32))
        if lw == 1:
            for lane in range(32):
                for o, val in ((64 * c + 2 * lane, v[lane]),
                               (64 * c + 2 * lane + 1, w[lane])):
                    if o < out:
                        kept[o] = val
            continue
        cur = [tree_add(v[lane], w[lane], 32 * c + lane, 1)
               for lane in range(32)]
        for l in range(2, lw):
            cur = [tree_add(cur[2 * lane % 32], cur[(2 * lane + 1) % 32],
                            (64 >> l) * c + lane, l) for lane in range(32)]
        for lane in range(128 >> lw):
            if (128 >> lw) * c + lane < out:
                kept[(128 >> lw) * c + lane] = cur[lane]
    if L == lw:
        return [kept[r] for r in range(rows)]
    cur = [kept[lane] if lane < out else junk(lw) for lane in range(32)]
    for l in range(lw, L):
        cur = [tree_add(cur[2 * lane % 32], cur[(2 * lane + 1) % 32], lane, l)
               for lane in range(32)]
    return cur[:rows]


@pytest.mark.parametrize("K,rows", [(1, 5), (2, 3), (3, 85), (5, 7), (16, 16),
                                    (33, 7), (64, 4), (100, 2), (129, 1),
                                    (256, 1), (1000, 1), (1024, 1)])
def test_kernel_tree_schedule_is_the_reference_tree(K, rows):
    rng = np.random.default_rng(K)
    L = tree_levels(K)
    n = 4
    # the group's level-0 nodes: each row's K lanes, then not-real slots
    # holding whatever an earlier group left there
    level0 = [torch.from_numpy(rng.integers(-1, 2, n)).int()
              for _ in range(rows << L)]
    got = _kernel_tree(level0, K, rows, rng)
    for r in range(rows):
        want, _ = adder_tree(torch.stack(level0[r << L:(r << L) + K]))
        assert torch.equal(got[r], want), r
