"""The port's training substrates against the JAX reference: the LR
schedule, AdamW (clipping included), the global norm, int8 compression
with error feedback, the synthetic data pipeline, the fault handlers and
the checkpoint manager (the reference's tests/test_substrates.py
TestData / TestCheckpoint / TestOptim / TestCompression / TestFault, held
value for value against the reference where it has a counterpart).

Tolerances: the schedule to 1e-7 absolute, AdamW over 5 steps to 1e-6
relative (f32 pow and sqrt may round differently by an ulp), the global
norm to 1e-6 relative (a sum of f32 squares in another association);
compress_int8's q and scale bit for bit, the data pipeline's batches bit
for bit.
"""
import dataclasses
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.synthetic import SyntheticLMDataset as JData
from repro.distributed.fault import StragglerWatchdog as JWatchdog
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.compression import compress_int8 as jax_compress_int8
from repro.optim.compression import ef_compress_tree as jax_ef_compress_tree
from repro.optim.schedule import cosine_schedule as jax_cosine_schedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data.synthetic import SyntheticLMDataset, make_batches
from repro_torch.distributed.fault import (PreemptionGuard, StragglerWatchdog,
                                           retry_step)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           ef_compress_tree)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_str


def seeded_tree(seed, scale=1.0):
    """The same tree of f32 leaves as numpy (a dict with a nested dict and
    a list, 1-D and 2-D leaves)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"w": a(8, 5), "b": a(5), "blocks": [{"k": a(3, 4)}, {"k": a(4)}],
            "norm": {"scale": a(6)}}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def np_leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def t_leaves(tree):
    return [l.numpy() for l in tree_leaves(tree)]


# ---------------------------------------------------------------- trees

def test_tree_flatten_order_is_jax_tree_util():
    tree = seeded_tree(0)
    want = np_leaves(to_jax(tree))
    got = t_leaves(to_torch(tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tree_str({"a": 1, "b": [2, None]}) == \
        "PyTreeDef({'a': *, 'b': [*, None]})"
    assert tree_flatten({"ef": None})[0] == []


def _cycle_garbage(fn):
    """The tensors fn leaves in reference cycles: garbage the cyclic
    collector alone frees (and, for device tensors, only when it happens
    to run)."""
    import gc
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        fn()
        gc.collect()
        return [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


def test_walked_trees_free_their_leaves_with_their_last_reference():
    """F8: the port's tree walks (tree.py, the Sharder's path_leaves /
    spec_leaves, the checkpoint's sharding walk) were nested functions
    that called themselves, a reference cycle through their closure that
    held every leaf until the cyclic collector ran (jax.tree_util, in
    C++, holds none). A train step of the smoke InternLM2 left 42 tensors,
    twice its params' bytes, in cycles each step; now none."""
    from repro_torch.checkpoint.manager import _sharding_leaves
    from repro_torch.distributed.sharding import path_leaves, spec_leaves
    from repro_torch.distributed.train import build_train_step, \
        init_train_state
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map, tree_unflatten
    tree = {"a": [torch.ones(3), None], "b": (torch.ones(2),)}

    def walks():
        leaves, td = tree_flatten(tree)
        tree_unflatten(td, [t * 2 for t in leaves])
        tree_map(torch.neg, tree)
        path_leaves(tree)
        spec_leaves({"a": [(None,), None], "b": ((None,),)}, tree)
        _sharding_leaves(tree, td)

    assert _cycle_garbage(walks) == []
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), remat="block")
    model = Model(cfg, device="cpu")
    state = init_train_state(model)
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32)}
    step = build_train_step(model)
    step(state, batch)          # the first call's lazy set-up aside
    assert _cycle_garbage(lambda: step(state, batch)) == []


# ---------------------------------------------------------------- optim

def test_cosine_schedule_equals_the_reference():
    for kw in ({}, dict(warmup=10, total=100), dict(warmup=0, total=50,
                                                     min_frac=0.0)):
        for step in range(201):
            want = float(jax_cosine_schedule(jnp.asarray(step, jnp.int32),
                                             **kw))
            got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-7, (kw, step)
    assert float(cosine_schedule(0)) == 0.0


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["unclipped", "clipped"])
def test_adamw_update_equals_the_reference(clip):
    jcfg = JAdamWConfig(lr=1e-2, clip_norm=clip)
    cfg = AdamWConfig(lr=1e-2, clip_norm=clip)
    jp, tp = to_jax(seeded_tree(1)), to_torch(seeded_tree(1))
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    for step in range(5):
        g = seeded_tree(10 + step, scale=0.3)
        if step == 2:
            g["b"][:] = 0.0            # a zero gradient still decays
        sched = 0.5 + 0.1 * step
        jp, jopt, jm = jax_adamw_update(jcfg, to_jax(g), jopt, jp, sched)
        tp, topt, tm = adamw_update(cfg, to_torch(g), topt, tp, sched)
        for want, got in zip(np_leaves((jp, jopt["m"], jopt["v"])),
                             t_leaves((tp, topt["m"], topt["v"]))):
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        assert topt["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    if clip < 1.0:                 # the reported norm is the unclipped one
        assert float(tm["grad_norm"]) > clip


def test_adamw_decays_every_leaf_and_descends_a_quadratic():
    params = {"w": torch.tensor([2.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, opt, _ = adamw_update(cfg, {"w": g}, opt, params)
    assert float(params["w"].abs().max()) < 0.05
    # decay alone on a zero gradient: pf - lr * wd * pf
    p = {"s": torch.ones(3)}
    new, _, _ = adamw_update(AdamWConfig(lr=0.5, weight_decay=0.1),
                             {"s": torch.zeros(3)}, adamw_init(p), p)
    assert torch.equal(new["s"], torch.full((3,), 1.0 - 0.5 * 0.1))


def test_global_norm_equals_the_reference():
    tree = seeded_tree(2)
    want = float(jax_global_norm(to_jax(tree)))
    got = global_norm(to_torch(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_compress_int8_is_bit_equal(rng):
    for g in (rng.standard_normal(1000).astype(np.float32),
              # exact halves of the scale: round half to even
              (np.arange(-12, 13, dtype=np.float32) * 0.5) * (2.0 / 127),
              np.zeros(7, np.float32)):
        jq, js = jax_compress_int8(jnp.asarray(g))
        tq, ts = compress_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts).tobytes() == np.asarray(js).tobytes()
        err = np.abs(decompress_int8(tq, ts).numpy() - g)
        assert err.max() <= float(ts) * 0.5 + 1e-7


def test_ef_compress_tree_equals_the_reference():
    jef = tef = None
    for step in range(5):
        g = seeded_tree(20 + step, scale=1e-3)
        jd, jef = jax_ef_compress_tree(to_jax(g), jef)
        td, tef = ef_compress_tree(to_torch(g), tef)
        assert all(e.dtype == torch.float32 for e in tree_leaves(tef))
        for want, got in zip(np_leaves((jd, jef)), t_leaves((td, tef))):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_error_feedback_is_unbiased(rng):
    g = {"w": torch.from_numpy((rng.standard_normal(256) * 1e-3)
                               .astype(np.float32))}
    ef, acc = None, np.zeros(256)
    for _ in range(64):
        deq, ef = ef_compress_tree(g, ef)
        acc += deq["w"].numpy()
    want = g["w"].numpy() * 64
    assert np.abs(acc - want).max() <= np.abs(g["w"].numpy()).max() + 1e-6


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("arch", ["internlm2_1_8b", "seamless_m4t_medium",
                                  "llama_3_2_vision_11b"])
def test_batches_are_the_references(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    for seed in (0, 3, 11):
        jd, td = JData(jcfg, 4, 48, seed=seed), SyntheticLMDataset(
            cfg, 4, 48, seed=seed)
        np.testing.assert_array_equal(td.motifs, jd.motifs)
        for step in range(4):
            want, got = jd.batch(step), td.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    # 2-process host sharding: each process its own slice, as the reference's
    for i in range(2):
        want = JData(jcfg, 8, 32, seed=1, process_index=i,
                     process_count=2).batch(5)
        got = SyntheticLMDataset(cfg, 8, 32, seed=1, process_index=i,
                                 process_count=2).batch(5)
        assert got["tokens"].shape[0] == 4
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_stream_restarts_and_refuses_a_ragged_split():
    cfg = smoke_config("internlm2_1_8b")
    d = SyntheticLMDataset(cfg, 8, 64, seed=3)
    it = make_batches(cfg, global_batch=8, seq_len=64, seed=3, start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], d.batch(5)["tokens"])
    with pytest.raises(ValueError):
        SyntheticLMDataset(cfg, 6, 8, process_count=4)


# ---------------------------------------------------------------- fault

def test_watchdog_flags_the_references_steps():
    rng = np.random.default_rng(4)
    walls = list(0.1 + 0.002 * rng.standard_normal(60))
    walls[25], walls[40], walls[41] = 5.0, 0.9, 0.12
    for kw in ({}, dict(warmup_steps=5, z_threshold=3.0, alpha=0.2)):
        jw, tw, seen = JWatchdog(**kw), StragglerWatchdog(
            on_straggler=lambda s, dt: seen.append(s), **kw), []
        for i, dt in enumerate(walls):
            assert tw.observe(i, dt) == jw.observe(i, dt)
        assert tw.flagged == jw.flagged == seen
        assert 25 in tw.flagged
        assert (tw.mean, tw.var, tw.n) == (jw.mean, jw.var, jw.n)
    wd = StragglerWatchdog()
    wd.start()
    assert wd.stop(0) is False and wd.n == 1
    with pytest.raises(AssertionError):
        wd.stop(1)


def test_preemption_guard_and_retry_step():
    before = signal.getsignal(signal.SIGUSR1)
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
        assert not g.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert g.preempted
    assert signal.getsignal(signal.SIGUSR1) == before
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient collective failure")
        return x

    assert retry_step(flaky, 42, retries=3, backoff=0.001) == 42
    calls["n"] = -10
    with pytest.raises(RuntimeError):
        retry_step(flaky, 1, retries=1, backoff=0.001)


# ---------------------------------------------------------------- checkpoint

def state_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g),
                       "layers": [{"s": torch.randn(3, generator=g)
                                   .to(torch.bfloat16)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "ef": None}


def assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_checkpoint_round_trip_and_manifest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = state_tree()
    mgr.save(10, tree)
    assert mgr.latest_step() == 10
    like = {"params": {"w": torch.zeros(4, 3), "layers": [
        {"s": torch.zeros(3, dtype=torch.bfloat16)}]},
        "opt": {"step": torch.zeros((), dtype=torch.int32)}, "ef": None}
    out = mgr.restore(like)
    assert_bit_equal(out, tree)
    man = json.loads((tmp_path / "step_00000010" / "manifest.json")
                     .read_text())
    assert man["step"] == 10 and man["n_leaves"] == 3
    assert [l["dtype"] for l in man["leaves"]] == ["int32", "bfloat16",
                                                   "float32"]
    assert man["leaves"][2]["shape"] == [4, 3]
    assert man["treedef"].startswith("PyTreeDef({'ef': None")
    with np.load(tmp_path / "step_00000010" / "shard_0.npz") as data:
        assert sorted(data.files) == ["leaf_0", "leaf_1", "leaf_2"]
        assert data["leaf_1"].dtype == np.int16       # bf16's bit pattern
    # restore takes the dtype of the target's leaf
    f32 = mgr.restore({**like, "params": {**like["params"], "layers": [
        {"s": torch.zeros(3)}]}})
    assert f32["params"]["layers"][0]["s"].dtype == torch.float32
    assert torch.equal(f32["params"]["layers"][0]["s"],
                       tree["params"]["layers"][0]["s"].float())


def test_checkpoint_keep_k_and_no_tmp_visible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(3)})
    assert mgr.all_steps() == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))
    (tmp_path / "step_00000009.tmp").mkdir()     # a crashed write
    assert mgr.latest_step() == 4


def test_checkpoint_async_save_copies_before_the_thread(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    x = torch.arange(5.0)
    mgr.save(7, {"x": x})
    x.add_(100.0)                 # the next step changes the tensor
    mgr.wait()
    assert mgr.latest_step() == 7
    assert torch.equal(mgr.restore({"x": torch.zeros(5)})["x"],
                       torch.arange(5.0))


def test_checkpoint_mismatch_and_shardings_raise(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(3)})
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"x": torch.zeros(3), "y": torch.zeros(2)})
    # shardings= with a None leaf restores that leaf whole, as without
    assert torch.equal(mgr.restore({"x": torch.ones(3)},
                                   shardings={"x": None})["x"],
                       torch.zeros(3))


def test_remat_is_a_config_field_of_the_reference():
    assert smoke_config("internlm2_1_8b").remat == "none"
    assert dataclasses.replace(smoke_config("mamba2_130m"),
                               remat="block").remat == "block"
    # "full" is accepted by both packages (and acts as "none": only
    # "block" checkpoints, test_torch_train.py::test_remat_full_is_none)
    for smoke in (smoke_config, jax_smoke_config):
        assert dataclasses.replace(smoke("internlm2_1_8b"),
                                   remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(smoke_config("mamba2_130m"), remat="layer")
