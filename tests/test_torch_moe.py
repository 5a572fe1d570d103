"""The port's MoE layer (`repro_torch/models/moe.py`) against the JAX
reference's on the same weights and inputs: `_capacity`, the per-row
dispatch plan of `_route_row` (token per slot, slot, token, weight and
keep flag per sorted assignment, the aux loss), `_route_rows` routing
every row at once (each row's plan bit for bit the row's alone, and the
reference's vmapped), and `moe_apply`, without
capacity drops (the smoke configs' capacity factor of 4), with them (a
capacity factor of 1 and a router that piles every token onto one
expert, so the sink slot takes the overflow) and with tied gates (where
top-k takes the lower expert index first, as jax.lax.top_k does).

The plans' indices and keep flags are held exactly, their combine
weights and the aux loss within 1e-5 relative (the router's f32 matmul
sums in another order); `moe_apply` within 1e-5 of the largest |output|
at f32 (the expert einsums sum in another order too) and 3e-2 at bf16.
The combine itself (`_combine`) is held bit for bit on hand-made updates
whose sum depends on the order of the adds: each token's updates added
one at a time in ascending slot order, as the reference's scatter-add
adds them, on one device in bf16 and on each rank's experts in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models import moe as jmoe
from repro_torch.configs import smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.models import moe as tmoe

ARCH = "mixtral_8x22b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**over):
    return (dataclasses.replace(jax_smoke_config(ARCH), **over),
            dataclasses.replace(smoke_config(ARCH), **over))


def params(jcfg, router=None):
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    if router is not None:
        jp["router"] = jnp.asarray(router)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def piled_router(d, E, seed=2):
    """A router whose first expert outscores every other for every token
    of a positive input: all top-1 choices land on expert 0."""
    r = 0.01 * rand((d, E), seed)
    r[:, 0] += 0.05
    return r


def tied_router(d, E, seed=3):
    """Experts in pairs (0,1), (2,3), ... with equal router columns: every
    gate ties with its partner's."""
    r = 0.1 * rand((d, E // 2), seed)
    return np.repeat(r, 2, axis=1)


ROUTERS = {
    "no-drops": (dict(), None, False),
    "drops": (dict(capacity_factor=1.0), piled_router, True),
    "tied": (dict(), tied_router, False),
}


@pytest.fixture(params=sorted(ROUTERS))
def routed(request):
    over, make, positive = ROUTERS[request.param]
    jcfg, cfg = cfgs(**over)
    router = None if make is None else make(cfg.d_model, cfg.n_experts)
    jp, tp = params(jcfg, router)
    x = rand((2, 16, cfg.d_model), 4)
    if positive:
        x = np.abs(x)
    return request.param, jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("T", [1, 7, 16, 33, 100])
def test_capacity_matches_reference(T):
    for cf in (1.0, 1.25, 4.0):
        jcfg, cfg = cfgs(capacity_factor=cf)
        assert tmoe._capacity(T, cfg) == jmoe._capacity(T, jcfg)


def test_route_row_plan_matches_reference(routed):
    case, jcfg, cfg, jp, tp, x = routed
    for row in x:
        want = jmoe._route_row(jnp.asarray(row), jp["router"], jcfg)
        got = tmoe._route_row(torch.from_numpy(row), tp["router"], cfg)
        names = ("buf_tok", "slot", "st", "sw", "keep")
        for name, w, g in zip(names, want[:5], got[:5]):
            w, g = np.asarray(w), g.numpy()
            if name == "sw":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype), name)
        assert abs(float(got[5]) - float(want[5])) <= 1e-5 * float(want[5])
    keep = got[4]
    if case == "drops":
        assert not bool(keep.all())             # the sink took the overflow
        E, C = cfg.n_experts, tmoe._capacity(x.shape[1], cfg)
        assert bool((got[1][~keep] == E * C).all())
    else:
        assert bool(keep.all())


def _rows_against_row(jcfg, cfg, jp, tp, x):
    """`_route_rows` over every row of x (B, T, d) at once: each row's
    plan bit for bit `_route_row`'s on the row alone, and the reference's
    `_route_row` vmapped over the rows (indices and keep flags exactly,
    weights and aux within 1e-5 relative)."""
    got = tmoe._route_rows(torch.from_numpy(x), tp["router"], cfg)
    for b, row in enumerate(x):
        one = tmoe._route_row(torch.from_numpy(row), tp["router"], cfg)
        for g, w in zip(got, one):
            assert torch.equal(g[b], w)
    want = jax.vmap(lambda r: jmoe._route_row(r, jp["router"], jcfg))(
        jnp.asarray(x))
    for name, w, g in zip(("buf_tok", "slot", "st", "sw", "keep", "aux"),
                          want, got):
        w, g = np.asarray(w), g.numpy()
        if name in ("sw", "aux"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), name)
    return got


def test_batched_routing_gives_each_rows_plan(routed):
    case, jcfg, cfg, jp, tp, x = routed
    _rows_against_row(jcfg, cfg, jp, tp, x)


def test_batched_routing_on_a_random_batch_and_the_drops_row():
    jcfg, cfg = cfgs()
    jp, tp = params(jcfg)
    _rows_against_row(jcfg, cfg, jp, tp, rand((8, 24, cfg.d_model), 6))
    # the partitioned serve test's drops row: 2 experts, both of them a
    # token, capacity 8 of each expert's 12 assignments
    from torch_rank_cases import MOE_DROPS, MOE_DROPS_TOKENS
    jcfg, cfg = cfgs(**MOE_DROPS[1])
    jp, tp = params(jcfg)
    got = _rows_against_row(jcfg, cfg, jp, tp,
                            rand((1, MOE_DROPS_TOKENS, cfg.d_model), 7))
    assert int((~got[4]).sum()) == 8            # 4 dropped an expert


def test_tied_gates_take_the_lower_expert_first():
    jcfg, cfg = cfgs()
    router = tied_router(cfg.d_model, cfg.n_experts)
    jp, tp = params(jcfg, router)
    x = torch.from_numpy(rand((16, cfg.d_model), 5))
    gates = torch.softmax(x @ tp["router"], dim=-1)
    assert bool((gates[:, 0::2] == gates[:, 1::2]).all())   # exact ties
    _, slot, st, _, _, _ = tmoe._route_row(x, tp["router"], cfg)
    C = tmoe._capacity(16, cfg)
    experts = torch.div(slot, C, rounding_mode="floor")
    # each token's two picks are a tied pair, the even expert first
    order = torch.argsort(st, stable=True)
    picks = experts[order].reshape(16, 2)
    assert bool((picks[:, 0] % 2 == 0).all())
    assert bool((picks[:, 1] == picks[:, 0] + 1).all())


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_moe_apply_matches_reference(routed, dt, tol):
    case, jcfg, cfg, jp, tp, x = routed
    jcfg = dataclasses.replace(jcfg, compute_dtype=dt)
    cfg = dataclasses.replace(cfg, compute_dtype=dt)
    xj = jnp.asarray(x, jcfg.cdtype)
    xt = torch.from_numpy(x).to(cfg.cdtype)
    yw, aw = jmoe.moe_apply(jp, jcfg, xj, JEngine(mode="native"))
    yg, ag = tmoe.moe_apply(tp, cfg, xt, DotEngine(mode="native"))
    assert yg.dtype == cfg.cdtype and yg.shape == xt.shape
    yw = np.asarray(yw.astype(jnp.float32))
    yg = yg.to(torch.float32).numpy()
    assert np.abs(yw - yg).max() <= tol * np.abs(yw).max()
    assert abs(float(ag) - float(aw)) <= 1e-5 * float(aw)
    if case == "drops" and dt == "float32":
        # a dropped assignment adds nothing: each token's output is the
        # weighted sum of its kept experts' FFNs alone
        xr = torch.from_numpy(x[0])
        _, slot, st, sw, keep, _ = tmoe._route_row(xr, tp["router"], cfg)
        C = tmoe._capacity(x.shape[1], cfg)
        want = torch.zeros_like(xr)
        for s_, t, w in zip(slot[keep].tolist(), st[keep].tolist(),
                            sw[keep].tolist()):
            e = s_ // C
            g = torch.nn.functional.silu(xr[t] @ tp["wg"][e])
            want[t] += w * ((g * (xr[t] @ tp["wu"][e])) @ tp["wd"][e])
        assert float((want - torch.from_numpy(yg[0])).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen3_moe_235b_a22b"])
def test_the_route_walks_on_meta_at_full_width(arch):
    """The route has no shape that depends on the data (no boolean index),
    so the dry run can walk a MoE layer on the meta device: each published
    config's plan has the reference's shapes and dtypes, one layer's FLOPs
    are the router's and the three expert einsums' over the (E, C) buffer,
    and a prefill at full width and depth runs to its logits."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import walk
    from repro_torch.models.model import Model
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    B, T, d, E = 2, 64, cfg.d_model, cfg.n_experts
    jx = jax.ShapeDtypeStruct((T, d), jnp.float32)
    jr = jax.ShapeDtypeStruct((d, E), jnp.float32)
    want = jax.eval_shape(lambda x, r: jmoe._route_row(x, r, jcfg), jx, jr)
    meta = Model(cfg, device="meta")
    p = meta.init(0)["layers"][0]["moe"]
    got = tmoe._route_row(torch.empty((T, d), device="meta"), p["router"],
                          cfg)
    for w, g in zip(want, got):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        # the port's indices are int64 where JAX (no x64) keeps int32
        kind = np.dtype(str(g.dtype).split(".")[-1]).kind
        assert kind == np.dtype(w.dtype).kind
    x = torch.empty((B, T, d), dtype=cfg.cdtype, device="meta")
    flops = walk(tmoe.moe_apply, p, cfg, x, DotEngine(mode="native"))[
        "flops"]
    C = tmoe._capacity(T, cfg)
    assert flops == B * 2 * T * d * E + 3 * 2 * B * E * C * d * cfg.d_ff
    tokens = torch.empty((1, 32), dtype=torch.int32, device="meta")
    logits, _, _ = meta.prefill(meta.init(0), {"tokens": tokens},
                                meta.init_cache(1, 32))
    assert tuple(logits.shape) == (1, cfg.vocab_padded)


def _hand_plan(topi, E, C):
    """(token per (expert, slot) (E * C,), each sorted assignment's slot
    (sink E * C when dropped) and token (T * K,)) of the top-k choices
    topi (T, K), as `_route_row` lays them out."""
    T, K = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(T).repeat_interleave(K)[order]
    pos = torch.arange(T * K) - torch.searchsorted(se, se)
    kept = pos < C
    slot = torch.where(kept, se * C + pos, torch.full_like(se, E * C))
    buf = torch.full((E * C,), T, dtype=torch.int64)
    buf[slot[kept]] = st[kept]
    return buf, slot, st


# 3 tokens, 3 experts each, of 4 experts with 2 slots: expert 2 takes
# tokens 0 and 1 and drops token 2's assignment
F10_TOPI = torch.tensor([[0, 1, 2], [0, 2, 3], [1, 2, 3]])
F10_E, F10_C = 4, 2


def _order_updates(slot, st, T, small, dtype):
    """(E * C, 4) updates: a token's first kept slot 1, its later ones
    `small`, half an ulp of 1 in `dtype` (each column scaled by a power of
    two), so that 1 + small + small rounds to 1 in slot order and to
    1 + 2 small in the reverse one; the empty slots hold 7, which no sum
    may take."""
    upd = torch.full((F10_E * F10_C, 4), 7.0, dtype=torch.float64)
    for t in range(T):
        mine = sorted(s for s, tt in zip(slot.tolist(), st.tolist())
                      if tt == t and s < F10_E * F10_C)
        for i, s_ in enumerate(mine):
            upd[s_] = 1.0 if i == 0 else small
    return (upd * torch.tensor([1.0, -1.0, 2.0, 0.5], dtype=torch.float64)
            ).to(dtype)


def _in_order(upd, slot, st, T, lo, hi, reverse=False):
    """Each token's updates of the slots in [lo, hi), added one at a time
    in ascending (or descending) slot order from zeros, in upd's dtype."""
    out = torch.zeros((T, upd.shape[1]), dtype=upd.dtype)
    for t in range(T):
        mine = sorted((s for s, tt in zip(slot.tolist(), st.tolist())
                       if tt == t and lo <= s < hi), reverse=reverse)
        for s_ in mine:
            out[t] = out[t] + upd[s_]
    return out


def test_the_combine_adds_each_tokens_updates_in_ascending_slot_order():
    """F10: CUDA's index_add_ adds with atomics, in no fixed order. The
    combine adds a token's K updates one at a time in ascending slot
    order, each sum rounded to the accumulator's dtype: on one device in
    bf16 (the reference's scatter-add gives the same bits), on a rank's
    experts in f32 (the partitioned partials; CPU index_add_ gives those
    bits too). A dropped assignment and the slots of other ranks' experts
    add nothing."""
    E, C = F10_E, F10_C
    T = F10_TOPI.shape[0]
    buf, slot, st = _hand_plan(F10_TOPI, E, C)
    assert int((slot == E * C).sum()) == 1          # token 2's, dropped

    # one device, bf16: 1 + 2^-8 + 2^-8 is 1 in slot order, 1 + 2^-7
    # in the reverse order and in an f32 sum rounded once
    upd = _order_updates(slot, st, T, 2.0 ** -8, torch.bfloat16)
    got = tmoe._combine(upd[None], slot[None], st[None], T, 0)[0]
    want = _in_order(upd, slot, st, T, 0, E * C)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.equal(got, _in_order(upd, slot, st, T, 0, E * C,
                                          reverse=True))
    widened = torch.stack([upd[[s for s, tt in zip(slot.tolist(),
                                                   st.tolist())
                                if tt == t and s < E * C]].float().sum(0)
                           for t in range(T)]).to(torch.bfloat16)
    assert not torch.equal(got, widened)
    ju = jnp.asarray(upd.to(torch.float32).numpy(), jnp.bfloat16)
    ref = jnp.zeros((T + 1, 4), jnp.bfloat16).at[
        jnp.minimum(jnp.asarray(buf.numpy()), T)].add(ju)[:T]
    np.testing.assert_array_equal(
        np.asarray(ref.astype(jnp.float32)), got.to(torch.float32).numpy())

    # two ranks' experts, f32 partials: 1 + 2^-24 + 2^-24 is 1 in order
    upd = _order_updates(slot, st, T, 2.0 ** -24, torch.float32)
    partials = []
    for e0, e1 in ((0, E // 2), (E // 2, E)):
        lo, hi = e0 * C, e1 * C
        part = tmoe._combine(upd[None, lo:hi], slot[None], st[None], T,
                             lo)[0]
        assert torch.equal(part, _in_order(upd, slot, st, T, lo, hi))
        partials.append(part)
    whole = tmoe._combine(upd[None], slot[None], st[None], T, 0)[0]
    assert torch.equal(whole, _in_order(upd, slot, st, T, 0, E * C))
    assert not torch.equal(whole, _in_order(upd, slot, st, T, 0, E * C,
                                            reverse=True))
    # the CPU index_add_'s f32 bits, which the partitioned serve had
    assert torch.equal(whole, torch.zeros((T + 1, 4)).index_add_(
        0, buf.clamp(max=T), torch.where(buf[:, None] < T, upd,
                                         torch.zeros_like(upd)))[:T])
