"""The port's recurrent blocks (`repro_torch/models/recurrent.py`) against
the JAX reference's on the same weights and inputs: the RG-LRU and the
Mamba2 SSD mixer through a prefill without a state, a prefill from a
state and a single decode step; the causal conv carrying its state
across calls; `_segsum` and `ssd_chunked` at a length that is not a
multiple of the chunk; and the associative scan, which pairs its f32
products as jax.lax.associative_scan does, bit for bit.

Tolerance: 1e-3 of the largest |output| at f32 compute (the same as the
model tests), the states within 1e-3 of their largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models import recurrent as jrec
from repro_torch.configs import smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.models import recurrent as trec

TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    over = dict(compute_dtype="float32")
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def to_torch(tree):
    """A reference param or state dict as torch tensors, dtypes kept."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def to_np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel(want, got):
    want, got = to_np(want), to_np(got)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


MIXERS = {
    "rglru": ("recurrentgemma_9b", jrec.rglru_init, jrec.rglru_apply,
              jrec.rglru_state_init, trec.rglru_apply),
    "ssd": ("mamba2_130m", jrec.ssd_init, jrec.ssd_apply,
            jrec.ssd_state_init, trec.ssd_apply),
}


@pytest.fixture(scope="module", params=sorted(MIXERS))
def mixer(request):
    arch, jinit, japply, jstate, tapply = MIXERS[request.param]
    jcfg, cfg = cfgs(arch)
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    if request.param == "rglru":     # the reference's zero gate biases
        for k, seed in (("ba", 4), ("bi", 5)):
            jp[k] = jnp.asarray(rand(jp[k].shape, seed, 0.5))
    else:                            # and its zero dt bias
        jp["dt_bias"] = jnp.asarray(rand(jp["dt_bias"].shape, 4, 0.5))
    tp = to_torch(jax.tree.map(np.asarray, jp))

    def ref(x, state):
        y, st = japply(jp, jcfg, jnp.asarray(x), JEngine(mode="native"),
                       state=None if state is None else
                       {k: jnp.asarray(v) for k, v in state.items()})
        return np.asarray(y), (None if st is None
                               else {k: np.asarray(v) for k, v in st.items()})

    def port(x, state):
        st = None if state is None else {
            k: torch.from_numpy(np.array(v, np.float32))
            for k, v in state.items()}
        y, st = tapply(tp, cfg, torch.from_numpy(x), DotEngine(mode="native"),
                       state=st)
        return y.numpy(), (None if st is None
                           else {k: v.numpy() for k, v in st.items()})

    def random_state(seed):
        st = jstate(jcfg, 2)
        return {k: rand(v.shape, seed + i, 0.5)
                for i, (k, v) in enumerate(sorted(st.items()))}

    return request.param, jcfg, ref, port, random_state


@pytest.mark.parametrize("S", [1, 13])
def test_prefill_without_state_matches_reference(mixer, S):
    _, jcfg, ref, port, _ = mixer
    x = rand((2, S, jcfg.d_model), S)
    (yw, _), (yg, sg) = ref(x, None), port(x, None)
    assert sg is None and yg.shape == yw.shape
    assert rel(yw, yg) <= TOL


@pytest.mark.parametrize("S", [13])
def test_prefill_from_state_matches_reference(mixer, S):
    _, jcfg, ref, port, random_state = mixer
    x = rand((2, S, jcfg.d_model), 10 + S)
    state = random_state(20)
    (yw, sw), (yg, sg) = ref(x, state), port(x, state)
    assert rel(yw, yg) <= TOL
    assert set(sg) == set(sw) == {"h", "conv"}
    for k in sw:
        assert sg[k].dtype == np.float32
        assert rel(sw[k], sg[k]) <= TOL, k


def test_decode_step_matches_reference(mixer):
    _, jcfg, ref, port, random_state = mixer
    state = random_state(30)
    for step in range(3):
        x = rand((2, 1, jcfg.d_model), 40 + step)
        (yw, sw), (yg, sg) = ref(x, state), port(x, state)
        assert rel(yw, yg) <= TOL
        for k in sw:
            assert rel(sw[k], sg[k]) <= TOL, k
        state = sw


def test_prefill_then_decode_equals_one_prefill(mixer):
    # the port alone: a state carried out of a prefill and one decode step
    # give the outputs of one longer prefill from the same state
    _, jcfg, _, port, random_state = mixer
    x = rand((2, 9, jcfg.d_model), 50)
    state = random_state(60)
    y_all, s_all = port(x, state)
    y_a, s_a = port(x[:, :8], state)
    y_b, s_b = port(x[:, 8:], s_a)
    assert rel(y_all, np.concatenate([y_a, y_b], axis=1)) <= TOL
    for k in s_all:
        assert rel(s_all[k], s_b[k]) <= TOL


def test_causal_conv_carries_its_state_across_calls():
    kernel = rand((4, 6), 1)
    x = rand((2, 11, 6), 2)
    state = rand((2, 3, 6), 3)
    yw, cw = jrec._causal_conv(jnp.asarray(x), jnp.asarray(kernel),
                               jnp.asarray(state))
    yg, cg = trec._causal_conv(torch.from_numpy(x), torch.from_numpy(kernel),
                               torch.from_numpy(state))
    np.testing.assert_array_equal(np.asarray(cw), cg.numpy())
    assert rel(yw, yg) <= 1e-6
    # three calls with the carried state are one call over the whole input
    st, parts = torch.from_numpy(state), []
    for a, b in ((0, 4), (4, 5), (5, 11)):
        y, st = trec._causal_conv(torch.from_numpy(x[:, a:b]),
                                  torch.from_numpy(kernel), st)
        parts.append(y)
    assert rel(yg, torch.cat(parts, dim=1)) <= 1e-6
    np.testing.assert_array_equal(st.numpy(), cg.numpy())
    # no state: zeros before the first input
    y0, _ = trec._causal_conv(torch.from_numpy(x), torch.from_numpy(kernel))
    yz, _ = jrec._causal_conv(jnp.asarray(x), jnp.asarray(kernel))
    assert rel(yz, y0) <= 1e-6


@pytest.mark.parametrize("L", [1, 5, 8])
def test_segsum_matches_reference(L):
    x = -np.abs(rand((2, 3, L), L))
    want = np.asarray(jrec._segsum(jnp.asarray(x)))
    got = trec._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(want), np.isneginf(got))
    assert np.isneginf(got[..., np.triu_indices(L, 1)[0],
                           np.triu_indices(L, 1)[1]]).all()
    fin = np.isfinite(want)
    assert np.abs(want[fin] - got[fin]).max(initial=0.0) <= 1e-5
    # exp() of the upper triangle is exactly 0, of the diagonal exactly 1
    e = torch.exp(torch.from_numpy(got))
    assert (e[..., np.triu_indices(L, 1)[0], np.triu_indices(L, 1)[1]] == 0
            ).all()
    assert (torch.diagonal(e, dim1=-2, dim2=-1) == 1).all()


def _ssd_inputs(S, chunk, seed, H=3, P=4, N=5):
    pad = (-S) % chunk
    xh = rand((2, S, H, P), seed)
    dt = np.abs(rand((2, S, H), seed + 1, 0.5))
    Bm, Cm = rand((2, S, N), seed + 2), rand((2, S, N), seed + 3)
    A = -np.abs(rand((H,), seed + 4)) - 0.1
    h0 = rand((2, H, P, N), seed + 5, 0.5)
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (xh, dt, Bm, Cm)]
    return (xh, dt, Bm, Cm, A, h0), padded


@pytest.mark.parametrize("S,chunk", [(13, 8), (5, 8), (17, 4)])
def test_ssd_chunked_matches_reference_at_a_ragged_length(S, chunk):
    (xh, dt, Bm, Cm, A, h0), (xp, dp, bp, cp) = _ssd_inputs(S, chunk, S)
    yw, hw = jrec.ssd_chunked(*map(jnp.asarray, (xp, dp, A, bp, cp)), chunk,
                              h0=jnp.asarray(h0))
    yg, hg = trec.ssd_chunked(*map(torch.from_numpy, (xp, dp, A, bp, cp)),
                              chunk, h0=torch.from_numpy(h0))
    assert rel(yw, yg) <= TOL and rel(hw, hg) <= TOL
    # the dt = 0 padding leaves the carried state exact: the sequential
    # recurrence over the S real steps reaches the same state and outputs
    h, ys = h0.astype(np.float64), []
    for t in range(S):
        dA = np.exp(dt[:, t] * A[None])                          # (B, H)
        h = (h * dA[..., None, None]
             + np.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], xh[:, t]))
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    assert rel(h, hg) <= TOL
    assert rel(np.stack(ys, 1), yg[:, :S]) <= TOL


def _combine(c1, c2):
    (a1, b1), (a2, b2) = c1, c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 7, 33])
def test_associative_scan_pairs_as_the_reference(S):
    a = np.random.default_rng(S).uniform(0.5, 1.0, (2, S, 16)).astype(
        np.float32)
    b = rand((2, S, 16), S + 100)
    want = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = trec.associative_scan(trec._linear_combine,
                                (torch.from_numpy(a), torch.from_numpy(b)),
                                dim=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_softplus_is_jaxs_past_the_linear_cutover():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.5, 20.5, 40.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(trec._softplus(torch.from_numpy(x)).numpy(),
                               want, rtol=1e-6, atol=0)


def test_states_keep_f32_storage_under_bf16_compute():
    cfg = dataclasses.replace(smoke_config("recurrentgemma_9b"),
                              compute_dtype="bfloat16")
    p = trec.rglru_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert p["lam"].dtype == torch.float32
    state = trec.rglru_state_init(cfg, 2, "cpu")
    x = torch.from_numpy(rand((2, 5, cfg.d_model), 1)).to(torch.bfloat16)
    y, st = trec.rglru_apply(p, cfg, x, DotEngine(mode="native"), state=state)
    assert st is state and y.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in st.values())
    assert bool(st["h"].abs().sum() > 0)
