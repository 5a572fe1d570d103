"""The port's train step against the reference's own pieces, composed.

The reference's `build_train_step` cannot run on this JAX (its
`with_sharding_constraint` asserts on the explicit mesh axes that
`jax.make_mesh` gives), so the step is held against its composition:
`jax.value_and_grad(lm_loss)` on the params cast by the reference's rule
(f32 leaves of two or more dims of the stacked tree to the compute
dtype), the strided microbatch split and in-order accumulation,
`ef_compress_tree`, `cosine_schedule` and `adamw_update`, on the same
weights (`convert.params_from_jax`) and the same synthetic batches.
Gradients and updated params of the reference are carried into the
port's per-layer layout with `params_from_jax` and compared leaf by leaf.
The optimizer starts at step 50 in both, so the learning rate is not the
zero of step 0. Its peak is 3e-5: AdamW's direction m / (sqrt(v) + eps)
turns a gradient's last-bit differences into update differences of up to
a few percent of lr where |g| is near eps (measured: 1.7e-5 at lr 5e-3
after 2 steps on InternLM2's smoke config), so lr sets how closely two
correct steps can agree; at 3e-5 the updates stay over 10x the f32
tolerance.

Tolerances, each leaf against its largest |value|: 1e-5 at f32 compute
(loss, gradients, updated params, moments); at bf16, the loss to 1e-2
and the params to 5e-3 (the reference test's tolerance). Every arch's
gradients at f32 to 1e-4 (recurrences and expert routing through deeper
chains of f32 ops). F4: under olm16 the digit-mode GEMMs have derivative
zero, so which leaves get a zero gradient must be the reference's, and
the others must agree to 1e-4 of the same leaf's largest native gradient:
on Mixtral they carry the aux loss's gradient alone, small and cancelling
in the router softmax's backward over 8 tokens (measured: up to 2.0e-4 of
its own largest |value| and 3.9e-5 of the native scale, on the second
layer's router, where native agrees to 1.7e-6; InternLM2's are all zero). Under compress_grads the int8 codes turn a last-bit
gradient difference at a rounding boundary into a whole code, so that
step is held against the reference's `ef_compress_tree` and `adamw_update`
fed the port's gradients (1e-5), its loss against the reference's (1e-5).
remat="block" changes no bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.numerics import DotEngine as JEngine
from repro.models.model import Model as JModel
from repro.models.model import lm_loss as jax_lm_loss
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.compression import ef_compress_tree as jax_ef_compress_tree
from repro.optim.schedule import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import list_archs, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.numerics import DotEngine, EngineSpec
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.distributed.train import (build_decode_step,
                                           build_prefill_step,
                                           build_train_step, cast_params,
                                           init_train_state)
from repro_torch.models.model import Model, lm_loss
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

LR, START = 3e-5, 50
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **over):
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def states(jcfg, cfg, mode="native"):
    """(reference model, its state, port model, port state) on the same
    weights, the optimizer at step START in both."""
    jm = JModel(jcfg, JEngine(mode=mode))
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jp)
    jopt["step"] = jnp.asarray(START, jnp.int32)
    tm = Model(cfg, DotEngine(mode=mode), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    topt = adamw_init(tp)
    topt["step"] = torch.tensor(START, dtype=torch.int32)
    return (jm, {"params": jp, "opt": jopt, "ef": None},
            tm, {"params": tp, "opt": topt, "ef": None})


def ref_cast(jcfg, params):
    return jax.tree.map(lambda p: p.astype(jcfg.cdtype)
                        if p.ndim >= 2 and p.dtype == jnp.float32 else p,
                        params)


def ref_grads_fn(jm):
    def loss_fn(params, batch):
        return jax_lm_loss(jm, ref_cast(jm.cfg, params), batch)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def ref_step(jm, state, batch, *, microbatches=1, compress_grads=False,
             grads_fn=None):
    """The reference's train step, composed of its own pieces."""
    grads_fn = grads_fn or ref_grads_fn(jm)
    params = state["params"]
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if microbatches > 1:
        def split(x):
            y = x.reshape(x.shape[0] // microbatches, microbatches,
                          *x.shape[1:])
            return jnp.swapaxes(y, 0, 1)
        mbs = {k: split(v) for k, v in batch.items()}
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        loss_sum = jnp.zeros((), jnp.float32)
        for k in range(microbatches):
            (loss, metrics), g = grads_fn(params,
                                          {n: v[k] for n, v in mbs.items()})
            acc = jax.tree.map(jnp.add, acc, g)
            loss_sum = loss_sum + loss
        grads = jax.tree.map(lambda g: g / microbatches, acc)
        loss = loss_sum / microbatches
    else:
        (loss, metrics), grads = grads_fn(params, batch)
    ef = state["ef"]
    if compress_grads:
        grads, ef = jax_ef_compress_tree(grads, ef)
    lr_scale = jax_cosine_schedule(state["opt"]["step"], total=10_000)
    new_p, new_opt, om = jax_adamw_update(JAdamWConfig(lr=LR), grads,
                                          state["opt"], params, lr_scale)
    return ({"params": new_p, "opt": new_opt, "ef": ef},
            {**metrics, **om, "loss_total": loss}, grads)


def port_layout(tree, cfg):
    """A reference tree of params, grads or moments in the port's layout,
    in f32."""
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    return params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        tree), f32, device="cpu")


def assert_trees_close(got, want, tol, what):
    gl, td = tree_flatten(got)
    wl, wtd = tree_flatten(want)
    assert td == wtd and len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.detach().to(torch.float32).numpy()
        w = w.numpy()
        assert np.isfinite(g).all(), (what, i)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (what, i, err)


def batches(cfg, n, seed=5, batch=B, seq=S):
    data = SyntheticLMDataset(cfg, batch, seq, seed=seed)
    return [data.batch(k) for k in range(n)]


def run_both(arch, *, steps=2, microbatches=1, compress_grads=False,
             **over):
    jcfg, cfg = configs(arch, **over)
    jm, js, tm, ts = states(jcfg, cfg)
    step = build_train_step(tm, opt_cfg=AdamWConfig(lr=LR),
                            microbatches=microbatches,
                            compress_grads=compress_grads)
    grads_fn = ref_grads_fn(jm)
    out = []
    for batch in batches(cfg, steps):
        js, jmet, jg = ref_step(jm, js, batch, microbatches=microbatches,
                                compress_grads=compress_grads,
                                grads_fn=grads_fn)
        ts, tmet = step(ts, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        out.append((jmet, tmet))
    return cfg, js, ts, out


@pytest.mark.parametrize("microbatches", [1, 2], ids=["mb1", "mb2"])
def test_step_equals_the_composed_reference_at_f32(microbatches):
    cfg, js, ts, out = run_both("internlm2_1_8b", compute_dtype="float32",
                                microbatches=microbatches)
    for jmet, tmet in out:
        assert sorted(tmet) == sorted(jmet) == sorted(
            ["loss", "aux", "ppl_proxy", "grad_norm", "lr", "loss_total"])
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(ts["params"], port_layout(js["params"], cfg), 1e-5,
                       "params")
    for part in ("m", "v"):
        assert_trees_close(ts["opt"][part], port_layout(js["opt"][part], cfg),
                           1e-5, part)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == START + 2
    assert ts["ef"] is None


def port_grads(tm, params, batch, microbatches):
    """The port's gradients of the step, as its train step takes them."""
    parts = []
    for k in range(microbatches):
        mb = {n: torch.from_numpy(v[k::microbatches]) for n, v in batch.items()}
        parts.append(grads_of(tm, params, mb)[1])
    return [sum(gs) / microbatches if microbatches > 1 else gs[0]
            for gs in zip(*parts)]


@pytest.mark.parametrize("microbatches", [1, 2], ids=["mb1", "mb2"])
def test_compressed_step_equals_the_references_pieces(microbatches):
    # int8 codes turn a gradient's last-bit difference at a rounding
    # boundary into a whole code, so the compressed step is held against
    # the reference's ef_compress_tree and adamw_update (both leaf-wise)
    # fed the port's own gradients, which the cases above hold against the
    # reference's; the metrics before the quantizer against the reference
    jcfg, cfg = configs("internlm2_1_8b", compute_dtype="float32")
    jm, js, tm, ts = states(jcfg, cfg)
    step = build_train_step(tm, opt_cfg=AdamWConfig(lr=LR),
                            microbatches=microbatches, compress_grads=True)
    jp = [jnp.asarray(p.numpy()) for p in tree_leaves(ts["params"])]
    jopt = {"m": [jnp.asarray(p.numpy()) for p in tree_leaves(ts["opt"]["m"])],
            "v": [jnp.asarray(p.numpy()) for p in tree_leaves(ts["opt"]["v"])],
            "step": jnp.asarray(START, jnp.int32)}
    jef, grads_fn = None, ref_grads_fn(jm)
    for batch in batches(cfg, 2):
        g = [jnp.asarray(x.numpy()) for x in port_grads(
            tm, ts["params"], batch, microbatches)]
        deq, jef = jax_ef_compress_tree(g, jef)
        lr_scale = jax_cosine_schedule(jopt["step"], total=10_000)
        jp, jopt, jmet = jax_adamw_update(JAdamWConfig(lr=LR), deq, jopt, jp,
                                          lr_scale)
        js, jref, _ = ref_step(jm, js, batch, microbatches=microbatches,
                               compress_grads=True, grads_fn=grads_fn)
        ts, tmet = step(ts, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
        for k in ("loss", "aux", "ppl_proxy", "lr", "loss_total"):
            np.testing.assert_allclose(float(tmet[k]), float(jref[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        for name, got, want in (("params", ts["params"], jp),
                                ("m", ts["opt"]["m"], jopt["m"]),
                                ("v", ts["opt"]["v"], jopt["v"]),
                                ("ef", ts["ef"], jef)):
            got = tree_leaves(got)
            assert len(got) == len(want)
            for i, (a, b) in enumerate(zip(got, want)):
                b = np.asarray(b)
                assert a.dtype == torch.float32
                assert bool(torch.isfinite(a).all()), (name, i)
                err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
                assert err <= 1e-5, (name, i, err)


def test_step_equals_the_composed_reference_at_bf16():
    cfg, js, ts, out = run_both("internlm2_1_8b")
    assert cfg.compute_dtype == "bfloat16"
    for jmet, tmet in out:
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-2)
    want = port_layout(js["params"], cfg)
    for g, w in zip(tree_leaves(ts["params"]), tree_leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-3,
                                   rtol=5e-3)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "recurrentgemma_9b",
                                  "seamless_m4t_medium"])
def test_cast_params_casts_the_leaves_the_reference_casts(arch):
    over = dict(n_layers=5) if arch == "recurrentgemma_9b" else {}
    jcfg, cfg = configs(arch, **over)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    mask = jax.tree.map(lambda p: np.full(
        p.shape, p.ndim >= 2 and p.dtype == jnp.float32, np.float32), jp)
    want = tree_leaves(port_layout(mask, cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got = tree_leaves(cast_params(tp, cfg))
    assert len(got) == len(want)
    assert any(w.ndim == 1 and bool(w.all()) for w in want)  # stacked 1-D
    assert any(w.ndim == 1 and not bool(w.any()) for w in want)
    for g, w in zip(got, want):
        assert bool(w.all()) or not bool(w.any())
        assert (g.dtype == torch.bfloat16) == bool(w.all())


def short_batch(seed=3):
    """One (1, 8) batch: the olm GEMMs' plain versions (the port's) and
    oracle (the reference's) cost seconds a pass on the CPU even at smoke
    width."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (1, 8)).astype(np.int32)}


def grads_of(tm, tp, batch):
    leaves, td = tree_flatten(tp)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = lm_loss(tm, cast_params(tree_unflatten(td, live), tm.cfg),
                      batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def torch_batch(cfg, seed=5):
    return {k: torch.from_numpy(v) for k, v in batches(cfg, 1, seed)[0].items()}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b"])
def test_f4_digit_mode_gradients_are_the_references(arch):
    # the reference's oracle (use_pallas=False) rounds through jnp.round,
    # whose derivative is 0; the port's digit GEMMs are zero-derivative
    # autograd nodes, so every leaf gets a gradient, zero where the
    # reference's is
    jcfg, cfg = configs(arch, compute_dtype="float32")
    jm, js, tm, ts = states(jcfg, cfg, mode="olm16")
    batch = short_batch()
    (jloss, _), jg = ref_grads_fn(jm)(js["params"], {
        k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = grads_of(tm, ts["params"], {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tree_leaves(port_layout(jg, cfg))
    assert len(got) == len(want)
    zero = [not bool(w.any()) for w in want]
    assert [not bool(g.any()) for g in got] == zero
    if arch == "internlm2_1_8b":
        assert all(zero)
    else:          # the aux loss carries gradient to routers and experts
        assert 0 < sum(not z for z in zero) < len(zero)
    # f32 rounding in the backward follows the magnitudes it passes
    # through, those of the native gradient; the digit GEMMs leave only the
    # small, cancelling aux-loss part of it, so each leaf's error is held
    # against the same leaf's native gradient
    jn = JModel(jcfg, JEngine(mode="native"))
    (_, _), jgn = ref_grads_fn(jn)(js["params"], {
        k: jnp.asarray(v) for k, v in batch.items()})
    scale = tree_leaves(port_layout(jgn, cfg))
    for g, w, n in zip(got, want, scale):
        assert g.shape == w.shape
        err = (g - w).abs().max() / max(float(n.abs().max()), 1e-30)
        assert float(err) <= 1e-4


def test_f4_digit_mode_step_only_decays():
    # olm16 end to end through the train step: the gradients are zero, so
    # the update is the decay alone (and the first step's lr is 0)
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=1)
    tm = Model(cfg, device="cpu")
    state = init_train_state(tm, seed=0)
    step = build_train_step(tm, opt_cfg=AdamWConfig(lr=LR),
                            engine_spec=EngineSpec(mode="olm16"))
    batch = {"tokens": torch.from_numpy(short_batch()["tokens"])}
    p0 = state["params"]
    state, met = step(state, batch)
    assert float(met["grad_norm"]) == 0.0 and float(met["lr"]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0),
                                                 tree_leaves(state["params"])))
    p1 = state["params"]
    state, met = step(state, batch)
    lr = met["lr"]
    assert float(lr) > 0.0
    for a, b in zip(tree_leaves(p1), tree_leaves(state["params"])):
        want = a - lr * (torch.zeros_like(a) / (
            torch.sqrt(torch.zeros_like(a)) + 1e-8) + 0.1 * a)
        assert torch.equal(b, want)


@pytest.mark.parametrize("arch", list_archs())
def test_every_archs_gradients_are_the_references(arch):
    jcfg, cfg = configs(arch, compute_dtype="float32")
    jm, js, tm, ts = states(jcfg, cfg)
    batch = batches(cfg, 1, batch=2)[0]
    (jloss, _), jg = ref_grads_fn(jm)(js["params"], {
        k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = grads_of(tm, ts["params"], {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tree_leaves(port_layout(jg, cfg))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), i
        err = (g - w).abs().max() / max(float(w.abs().max()), 1e-30)
        assert float(err) <= 1e-4, (i, float(err))


@pytest.mark.parametrize("arch,over,seq", [
    ("recurrentgemma_9b", dict(n_layers=5), 16),
    ("mixtral_8x22b", {}, 16),
    ("mamba2_130m", {}, 16),
    ("seamless_m4t_medium", {}, 16),
    ("internlm2_1_8b", dict(n_layers=1), 768),     # the flash path
], ids=["recurrentgemma", "mixtral", "mamba2", "seamless", "flash"])
def test_remat_block_changes_no_bit(arch, over, seq):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    tm = Model(cfg, device="cpu")
    params = tm.init(seed=1)
    batch = torch_batch(cfg, seed=2) if seq == 16 else {
        k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
            cfg, 1, seq, seed=2).batch(0).items()}
    out = []
    for remat in ("none", "block"):
        m = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        out.append(grads_of(m, params, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_full_is_none():
    # the reference takes remat="full" and checkpoints under "block"
    # alone (repro/models/transformer.py), so a step under "full" is a
    # step under "none", bit for bit
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=2)
    batch = torch_batch(cfg, seed=2)
    out = []
    for remat in ("none", "full"):
        m = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        state, met = build_train_step(m)(init_train_state(m, seed=1), batch)
        out.append((met["loss"], tree_leaves(state)))
    (l0, s0), (l1, s1) = out
    assert torch.equal(l0, l1) and len(s0) == len(s1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_prefill_and_decode_steps_are_the_models():
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=1)
    tm = Model(cfg, device="cpu")
    params = tm.init(seed=0)
    toks = torch.from_numpy(batches(cfg, 1)[0]["tokens"][:2, :6])
    lg, cache, mem = build_prefill_step(tm)(params, {"tokens": toks[:, :5]},
                                            tm.init_cache(2, 8))
    want, _, _ = tm.prefill(params, {"tokens": toks[:, :5]},
                            tm.init_cache(2, 8))
    assert torch.equal(lg, want) and mem is None
    dl, _ = build_decode_step(tm)(params, toks[:, 5], torch.full((2,), 5),
                                  cache)
    assert dl.shape == (2, cfg.vocab_padded)


def test_a_sharded_engine_spec_is_refused():
    # no longer refused: with no sharder (no mesh) shard= is inert, as a
    # reference engine with a shard and no mesh is, and the step is the
    # unsharded olm16 step bit for bit
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=1)
    tm = Model(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in short_batch().items()}
    out = []
    for spec in (EngineSpec(mode="olm16", shard="m"),
                 EngineSpec(mode="olm16")):
        state, met = build_train_step(tm, engine_spec=spec)(
            init_train_state(tm, seed=1), batch)
        out.append((met["loss"], tree_leaves(state)))
    (l0, s0), (l1, s1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
