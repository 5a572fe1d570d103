"""The partitioned train step (`distributed/train.py::jit_train_step`,
the layers' collectives with a backward) over one gloo group of 4 CPU
ranks on a (data 2, model 2) mesh, against the reference.

One spawn a module runs every run of `torch_rank_cases.TP_TRAIN_RUNS`
(`tp_train_rank`; the TP_CASES configs at f32 compute: InternLM2 by
heads, 3 query heads and 1 KV head through `_rank_heads`, Yi under
fsdp_tp with a tied table, Qwen3-MoE's experts by expert, Mixtral's by
d_ff with a window of 4, RecurrentGemma's RG-LRU over `model`, Mamba2's
replicated weights, Llama-Vision's cross layer on patches, SeamlessM4T's
encoder and xdec layers on frames; InternLM2 also with 2 microbatches and
with compressed gradients, RecurrentGemma also under remat "block"), 2
steps of 4 x 8 each. The test process meanwhile takes `jax.grad` of the
reference's `lm_loss` on the whole params (one device, no mesh), and a
subprocess runs the reference's own `jit_train_step` on 4 host devices
under an Auto-axis `jax.sharding.Mesh` inside `jax.set_mesh` (the
Explicit axes of `make_local_mesh` trip its `with_sharding_constraint`).
Held, for every run:
  * each rank's gradient block of every leaf, after the first step's
    sums over the batch axes, within GRAD_TOL of that leaf's largest |g|
    of the reference's gradient (a missing or doubled sum is of the
    order of the gradient) plus the port's one-device gradient's own
    distance from it (at most 1.2e-5, Mamba2's a_log; 4e-6 elsewhere),
    and within GRAD_TOL of the port's one-device gradient;
  * each step's loss and grad_norm within METRIC_TOL (relative) of the
    reference step's, and each rank's params after the 2 steps within
    PARAM_TOL of the reference's blocks;
  * each rank's param blocks the reference Sharder's shard shapes, and
    its argument bytes (state and rows) the reference's compiled
    `memory_analysis().argument_size_in_bytes`;
  * the largest tensor a step makes on a rank smaller than the largest
    whole leaf of a `model`-sharded param: nothing is gathered whole;
  * `init_train_state(model, sharder=)` equal to `distribute_state` of
    the whole init, bit for bit;
  * the fsdp_tp embedding's two routes (`Partition.lookup`: the rows or
    the table gathered over `data`) give the whole table's rows and
    gradient.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import Model as JModel
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import Sharder
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.model import Model
from test_torch_tp_serve import _shard_shapes
from torch_rank_cases import (LOOKUP_IDS, TP_MESH, TP_TRAIN_BATCH,
                              TP_TRAIN_CASES, TP_TRAIN_RUNS, free_port,
                              tp_config,
                              tp_train_batches, tp_train_config,
                              tp_train_rank)

RANKS = 4
# relative to the leaf's largest |g|, to |loss| and |grad_norm|; params
# absolute. f32 compute: the row-parallel sums, the vocab-parallel
# logsumexp and the gradients' sums reorder f32 additions (the largest
# read here: 4e-6 of a leaf's largest |g|)
GRAD_TOL = 1e-5
METRIC_TOL = 1e-5
PARAM_TOL = 1e-5

REF_TRAIN = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
sys.path.insert(0, sys.argv[1])
from repro.configs import smoke_config
from repro.distributed.sharding import Sharder
from repro.distributed.train import jit_train_step
from repro.models.model import Model
from repro.optim.adamw import adamw_init
import torch_rank_cases as trc
given = pickle.load(open(os.path.join(sys.argv[2], "train_given.pkl"), "rb"))
mesh = Mesh(np.array(jax.devices()).reshape(trc.TP_MESH), ("data", "model"),
            axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
with jax.set_mesh(mesh):
    for run in sys.argv[3].split(","):
        case, kw, _ = trc.TP_TRAIN_RUNS[run]
        cfg = trc.tp_train_config(run, smoke_config)
        model, sharder = Model(cfg), Sharder(mesh, cfg)
        sharder.set_batch(trc.TP_TRAIN_BATCH)
        # numpy leaves: the step places them at its shardings
        params = given[case]
        state = {"params": params, "opt": jax.tree.map(
            np.asarray, adamw_init(params)), "ef": None}
        seen, args, exe = [], None, None
        for b in trc.tp_train_batches(cfg):
            if exe is None or kw.get("compress_grads"):
                # a compressed step's state gains its error tree: compiled
                # again
                exe = jit_train_step(model, sharder, state, list(b),
                                     **kw).lower(state, b).compile()
            if args is None:
                args = exe.memory_analysis().argument_size_in_bytes
            state, met = exe(*jax.device_put((state, b),
                                             exe.input_shardings[0]))
            seen.append([float(met["loss"]), float(met["grad_norm"])])
        out[run] = {"metrics": seen, "args": int(args),
                    "params": jax.tree.map(np.asarray, state["params"])}
pickle.dump(out, open(os.path.join(sys.argv[2], sys.argv[4]), "wb"))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(t, spec, coord):
    """The block of whole `t` at mesh coordinate `coord` ({axis: index})
    under `spec`, on the TP_MESH sizes."""
    sizes = dict(zip(("data", "model"), TP_MESH))
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else tuple(entry or ()):
            n = t.shape[d] // sizes[a]
            t = t.narrow(d, coord[a] * n, n)
    return t


def _coord(rank):
    d, m = divmod(rank, TP_MESH[1])
    return {"data": d, "model": m}


def _abstract_sharder(cfg):
    sharder = Sharder(make_abstract_mesh(TP_MESH, ("data", "model")), cfg)
    sharder.set_batch(TP_TRAIN_BATCH)
    return sharder


def _port_tree(tree, cfg):
    """{path: whole tensor} of a reference tree in the port's layout."""
    from repro_torch.distributed.sharding import path_leaves
    return dict(path_leaves(params_from_jax(tree, cfg, device="cpu")))


def _reference_grads(case, tree):
    """(jax.grad of the reference's lm_loss on the whole params and the
    first batch, one device, as the port's whole tree; the port's own
    one-device gradient of its lm_loss on the same params and batch)."""
    from repro_torch.distributed.sharding import path_leaves
    from repro_torch.distributed.train import _grads_of, cast_params
    cfg = tp_config(case, jax_smoke_config)
    jm = JModel(cfg)
    batch = tp_train_batches(cfg)[0]
    grads = jax.jit(jax.grad(lambda p: jax_lm_loss(jm, p, {
        k: jnp.asarray(v) for k, v in batch.items()})[0]))(
        jax.tree.map(jnp.asarray, tree))
    cfg = tp_config(case)
    params = params_from_jax(tree, cfg, device="cpu")
    _, _, one = _grads_of(Model(cfg, device="cpu"), params, {
        k: torch.from_numpy(v) for k, v in batch.items()},
        lambda p: cast_params(p, cfg))
    return (_port_tree(jax.tree.map(np.asarray, grads), cfg),
            dict(path_leaves(one)))


RUNS = list(TP_TRAIN_RUNS)


def _reference_run(run):
    """The reference run `run` is held to: its case's where it only adds
    remat (the same program, its forward recomputed)."""
    case, _, over = TP_TRAIN_RUNS[run]
    return case if over.get("remat") else run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank -> its outputs, the reference step's records, the reference
    gradients by case, the given params by case)."""
    import torch.multiprocessing as mp
    out_dir = str(tmp_path_factory.mktemp("tp_train"))
    given = {}
    for case in TP_TRAIN_CASES:
        jm = JModel(tp_config(case, jax_smoke_config))
        given[case] = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    torch.save(given, os.path.join(out_dir, "train_given.pt"))
    with open(os.path.join(out_dir, "train_given.pkl"), "wb") as f:
        pickle.dump(given, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), "JAX_PLATFORMS": "cpu"}
    # the runs the reference compiles (a remat run is its case's program),
    # in two processes at once
    todo = [r for r in TP_TRAIN_RUNS if _reference_run(r) == r]
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF_TRAIN, os.path.dirname(__file__),
         out_dir, ",".join(todo[i::2]), f"train_ref{i}.pkl"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    ctx = mp.start_processes(tp_train_rank, args=(RANKS, free_port(),
                                                  out_dir),
                             nprocs=RANKS, join=False, start_method="spawn")
    try:
        grads = {c: _reference_grads(c, given[c]) for c in TP_TRAIN_CASES}
        while not ctx.join(timeout=600):
            pass
        errs = [ref.communicate(timeout=600)[1] for ref in refs]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(out_dir, f"train_rank{r}.pt"),
                        weights_only=False) for r in range(RANKS)]
    reference = {}
    for i in range(2):
        with open(os.path.join(out_dir, f"train_ref{i}.pkl"), "rb") as f:
            reference.update(pickle.load(f))
    return ranks, reference, grads, given


@pytest.mark.parametrize("run", RUNS)
def test_gradient_blocks_match_reference_grad(runs, run):
    ranks, _, grads, _ = runs
    case = TP_TRAIN_RUNS[run][0]
    cfg = tp_train_config(run)
    sharder = _abstract_sharder(cfg)
    whole, one = grads[case]
    for r, res in enumerate(ranks):
        got = res[f"{run}/grads"]
        assert sorted(got) == sorted(whole)
        for path, g in got.items():
            want = whole[path]
            spec = sharder.param_spec(path, tuple(want.shape))
            scale = max(float(want.abs().max()), 1e-30)
            # plus the port's own one-device gradient's distance from the
            # reference's (up to 1.2e-5 on Mamba2's a_log, whose largest
            # |g| is 7.5e-6: the SSD's four-operand einsums contract in
            # another order)
            base = float((one[path] - want).abs().max()) / scale
            err = float((g - _block(want, spec, _coord(r))).abs().max())
            assert err / scale <= GRAD_TOL + base, (run, r, path, err / scale)
            err = float((g - _block(one[path], spec, _coord(r))).abs().max())
            assert err / scale <= GRAD_TOL, (run, r, path, "one device")


@pytest.mark.parametrize("run", RUNS)
def test_metrics_and_params_match_reference_step(runs, run):
    ranks, reference, _, _ = runs
    run_ref = _reference_run(run)
    want = np.asarray(reference[run_ref]["metrics"])
    cfg = tp_train_config(run)
    sharder = _abstract_sharder(cfg)
    params = _port_tree(reference[run_ref]["params"], cfg)
    for r, res in enumerate(ranks):
        got = res[f"{run}/metrics"].numpy()
        rel = np.abs(got - want) / np.abs(want)
        assert rel.max() <= METRIC_TOL, (run, r, got, want)
        for path, p in res[f"{run}/params"].items():
            block = _block(params[path], sharder.param_spec(
                path, tuple(params[path].shape)), _coord(r))
            err = float((p - block).abs().max())
            assert err <= PARAM_TOL, (run, r, path, err)


@pytest.mark.parametrize("run", RUNS)
def test_blocks_and_argument_bytes_match_reference(runs, run):
    ranks, reference, _, _ = runs
    shapes, _ = _shard_shapes(TP_TRAIN_RUNS[run][0])
    for r, res in enumerate(ranks):
        assert res[f"{run}/shapes"] == shapes
        assert res[f"{run}/args"] == reference[_reference_run(run)]["args"]


@pytest.mark.parametrize("run", [r for r in RUNS
                                 if tp_train_config(r).family != "ssm"])
def test_step_makes_no_whole_sharded_leaf(runs, run):
    ranks, _, _, _ = runs
    cfg = tp_train_config(run)
    sharder = _abstract_sharder(cfg)
    meta = Model(cfg, device="meta").init(0)
    from repro_torch.distributed.sharding import path_leaves
    sharded = [t.numel() * 4 for p, t in path_leaves(meta)
               if "model" in str(sharder.param_spec(p, tuple(t.shape)))]
    for r, res in enumerate(ranks):
        assert 0 < res[f"{run}/largest"] < max(sharded), (
            run, r, res[f"{run}/largest"], max(sharded))


@pytest.mark.parametrize("case", TP_TRAIN_CASES)
def test_sharded_init_equals_distributed_whole_init(runs, case):
    ranks, _, _, _ = runs
    assert all(bool(res[f"{case}/init"]) for res in ranks)


@pytest.mark.parametrize("ids", LOOKUP_IDS)
def test_fsdp_lookup_routes_give_the_whole_tables_rows_and_gradient(runs,
                                                                    ids):
    """`Partition.lookup` (the embedding under fsdp_tp) by the looked-up
    rows' gather and by the table's: each rank's rows the whole table's,
    its block's gradient the whole gradient's block."""
    ranks, _, _, _ = runs
    assert all(bool(res[f"lookup/{ids}"]) for res in ranks)
