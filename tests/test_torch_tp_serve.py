"""The partitioned serve steps (`distributed/train.py::jit_prefill_step` /
`jit_decode_step`, `distributed/partition.py`, the layers under a
partition context) over one gloo group of 4 CPU ranks on a (data 2,
model 2) mesh, against the reference.

One spawn a module runs every case of `torch_rank_cases.TP_CASES`
(`tp_rank`; smoke-size configs at f32 compute, 2 layers: the KV cache
over kv heads and over its length, 3 query heads over 2 ranks, fsdp_tp,
the Qwen1.5 / ChatGLM3 qkv bias, tied and untied heads, a padded
vocabulary; Qwen3-MoE's experts split by expert, Mixtral's by d_ff with
a sliding-window ring over kv heads and over its length; RecurrentGemma's
RG-LRU over `model` beside its ring, one pattern group and a remainder
layer; Mamba2's replicated weights with the batch over both axes;
Llama-3.2-Vision's cross layer and SeamlessM4T's encoder and xdec layers
on frontend embeddings, by heads and, 3 query heads and 1 kv head,
through the heads' ranges) and a MoE prefill that drops assignments. The
test process meanwhile runs the reference's Model and
Sharder on the same params, and a subprocess compiles the reference's
`jit_prefill_step` / `jit_decode_step` on a forced 4-device CPU mesh.
Held:
  * every local param and cache leaf of a rank has the shape of the
    reference Sharder's shard of that leaf (an AbstractMesh of the same
    sizes), the leading group axis of its stacked leaves aside;
  * each rank's argument bytes (its param and cache blocks, its rows of
    the batch and of the decode's memory) equal the reference's
    `memory_analysis().argument_size_in_bytes` of the compiled steps, less
    the reference cache's `len` counters (one int32 a pattern group: the
    port's cache has none), plus the bytes of the arguments jax.jit drops
    because the step does not read them (Mamba2's decode position);
  * the prefill and decode logits, gathered over the ranks, within
    LOGIT_TOL of the largest |logit| of the reference's `Model.prefill` /
    `decode_step` on the same params (`convert.py` carries them); the
    port's own whole path (no partition context) too; the prefill's
    memory on each rank the reference's rows of it, whole over `model`;
  * under olm16, a column-parallel GEMM is bit-equal to the plain K1's
    column block and a row-parallel one within `olm_error_bound`; in one
    olm16 serve, a rank's GEMMs issued equal its K1 calls and layer 0's
    wq output is the single device's column block, bit for bit;
  * the sharded init (`init_serve_params`) bit-equal to the whole init's
    serve blocks;
  * every rank along `model` routes each MoE layer's tokens alike (the
    same dispatch plan, drops included);
  * the MoE, recurrent, SSM and cross-attention archs build partitioned
    steps as published; a partitioned layer refuses chunks and a paged
    pool.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_abstract_mesh as jax_abstract_mesh
from repro.configs import smoke_config as jax_smoke_config
from repro.distributed.sharding import Sharder as JSharder
from repro.distributed.sharding import _path_str
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.distributed.sharding import P, Sharder
from repro_torch.distributed.train import (block_shape, jit_decode_step,
                                           jit_prefill_step)
from repro_torch.kernels.online_dot.matmul import (olm_error_bound,
                                                   olm_matmul)
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.layers import embed, rmsnorm
from repro_torch.models.model import Model
from torch_rank_cases import (MEMORY_CASES, MOE_CASES, MOE_DROPS_TOKENS,
                              TP_BATCH, TP_CASES, TP_LEN, TP_MESH,
                              TP_OLM_CASE, TP_OLM_GEMMS_PER_PASS, free_port,
                              moe_drops_tokens, tp_config, tp_frontend,
                              tp_gemm_operands, tp_inputs, tp_rank)

RANKS = 4
# relative to the largest |logit| of the reference: f32 compute; the
# row-parallel sums and the partial-softmax combine reorder f32 sums
# (the largest read here: 1.0e-6, 3 heads over 2 ranks)
LOGIT_TOL = 1e-5
SIZES = dict(zip(("data", "model"), TP_MESH))

REF_BYTES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[1])
from repro.configs import smoke_config
from repro.distributed.sharding import Sharder
from repro.distributed.train import jit_decode_step, jit_prefill_step
from repro.launch.mesh import make_local_mesh
from repro.models.model import Model
import torch_rank_cases as trc
mesh = make_local_mesh(*trc.TP_MESH)
out = {}
for name in trc.TP_CASES:
    cfg = trc.tp_config(name, smoke_config)
    model, sharder = Model(cfg), Sharder(mesh, cfg)
    sharder.set_batch(trc.TP_BATCH)
    params = jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    cache = jax.eval_shape(lambda: model.init_cache(trc.TP_BATCH, trc.TP_LEN))
    batch = {"tokens": jax.ShapeDtypeStruct((trc.TP_BATCH, trc.TP_PROMPT),
                                            jnp.int32)}
    tok = jax.ShapeDtypeStruct((trc.TP_BATCH,), jnp.int32)
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    front = (trc.TP_BATCH, cfg.n_frontend_tokens, cfg.d_model)
    if key is not None:
        batch[key] = jax.ShapeDtypeStruct(front, jnp.float32)
    # the decode takes the prefill's memory back, in the compute dtype
    memory = () if key is None else (jax.ShapeDtypeStruct(front, cfg.cdtype),)
    pre = jit_prefill_step(model, sharder, params, list(batch), cache)
    dec = jit_decode_step(model, sharder, params, cache,
                          has_memory=bool(memory))
    lens = [a for p, a in jax.tree_util.tree_flatten_with_path(cache)[0]
            if str(p[-1]).endswith("'len']")]

    def nbytes(leaves):
        return sum(a.size * a.dtype.itemsize for a in leaves)

    def shard(a, spec):
        # a device's block of an argument at its spec
        shape = NamedSharding(mesh, spec).shard_shape(a.shape)
        return jax.ShapeDtypeStruct(shape, a.dtype)

    def compiled(step, args, specs):
        # jax.jit drops an argument the step does not read (Mamba2's
        # decode reads no position, an enc-dec decode no encoder weight):
        # a device's bytes of it, at its spec, beside the rest's
        exe = step.lower(*args).compile()
        leaves = jax.tree_util.tree_leaves(args)
        at = jax.tree_util.tree_leaves(specs,
                                       is_leaf=lambda x: isinstance(x, P))
        assert len(at) == len(leaves)
        kept = exe._executable._kept_var_idx
        return (exe.memory_analysis().argument_size_in_bytes,
                nbytes([shard(a, spec) for i, (a, spec) in enumerate(zip(
                    leaves, at)) if i not in kept]))

    pspecs, cspecs = sharder.param_specs(params), sharder.cache_specs(cache)
    bd = P(sharder.batch_spec()[0])
    (pre_b, pre_u), (dec_b, dec_u) = (
        compiled(pre, (params, batch, cache),
                 (pspecs, sharder.batch_specs(list(batch)), cspecs)),
        compiled(dec, (params, tok, tok, cache, *memory),
                 (pspecs, bd, bd, cspecs) + (P(bd[0], None, None),)
                 * len(memory)))
    out[name] = {"prefill": pre_b, "prefill_unused": pre_u,
                 "decode": dec_b, "decode_unused": dec_u,
                 "len": nbytes(lens)}
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_biases(tree, seed=7):
    """The reference tree with seeded non-zero attention biases (its init
    leaves them zero)."""
    rng = np.random.default_rng(seed)
    for slot in tree["blocks"]["scan"]:
        for key in ("bq", "bk", "bv"):
            if key in slot.get("attn", {}):
                slot["attn"][key] = jnp.asarray(
                    0.5 * rng.standard_normal(slot["attn"][key].shape),
                    slot["attn"][key].dtype)
    return tree


def _reference(name, seed=0, **over):
    cfg = dataclasses.replace(tp_config(name, jax_smoke_config), **over)
    jm = JModel(cfg)
    return jm, _with_biases(jm.init(jax.random.PRNGKey(seed)))


def _batch(name, asarray):
    """The case's prompt batch: the tokens and, for a cross-attention
    case, its frontend embeddings."""
    key, front = tp_frontend(tp_config(name))
    batch = {"tokens": asarray(tp_inputs()[0])}
    if key is not None:
        batch[key] = asarray(front)
    return batch


def _reference_serve(name, jm, jp):
    """The reference's prefill and decode logits, (1 + steps, B, V), each
    step under jax.jit as its serve runs it (a third of the eager
    dispatch's wall here), and the prefill's memory (None without a
    frontend)."""
    _, steps, pos = (jnp.asarray(a) for a in tp_inputs())
    decode = jax.jit(jm.decode_step)
    logits, cache, memory = jax.jit(jm.prefill)(
        jp, _batch(name, jnp.asarray), jm.init_cache(TP_BATCH, TP_LEN))
    seen = [logits]
    for tok, p in zip(steps, pos):
        logits, cache = decode(jp, tok, p, cache, memory)
        seen.append(logits)
    return (np.stack([np.asarray(a, np.float32) for a in seen]),
            None if memory is None else np.asarray(memory, np.float32))


def _port_whole_logits(name, tree):
    """The port's whole path (no partition context) on the same params."""
    from repro_torch.convert import params_from_jax
    cfg = tp_config(name)
    model = Model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    _, steps, pos = (torch.from_numpy(a) for a in tp_inputs())
    logits, cache, memory = model.prefill(params,
                                          _batch(name, torch.from_numpy),
                                          model.init_cache(TP_BATCH, TP_LEN))
    seen = [logits]
    for tok, p in zip(steps, pos):
        logits, cache = model.decode_step(params, tok, p, cache, memory)
        seen.append(logits)
    return torch.stack(seen).numpy()


def _shard_shapes(name):
    """{port path: the reference Sharder's shard shape} of every param and
    cache leaf on an AbstractMesh of the test's sizes. The reference
    stacks pattern slot s of group g, the port's layer g * pattern + s,
    over a leading (groups,) axis; its remainder layers follow
    unstacked."""
    cfg = tp_config(name, jax_smoke_config)
    sharder = JSharder(jax_abstract_mesh(TP_MESH, ("data", "model")), cfg)
    sharder.set_batch(TP_BATCH)
    jm = JModel(cfg)
    pat = len(cfg.block_pattern)
    n_scan = cfg.n_layers // pat * pat

    def leaves(tree):
        out = []
        jax.tree_util.tree_map_with_path(
            lambda p, a: out.append((_path_str(p), tuple(a.shape))), tree)
        return out

    def shard(shape, spec):
        return block_shape(shape, P(*tuple(spec)), SIZES)

    def layers(where, slot, shape, got, pat=pat, n_scan=n_scan):
        """(port layer, its shape) of a stacked slot or a remainder layer"""
        if where == "scan":
            return [(g * pat + int(slot), got[1:]) for g in range(shape[0])]
        return [(n_scan + int(slot), got)]

    params, cache = {}, {}
    tree = jax.eval_shape(jm.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    for path, shape in leaves(tree):
        got = shard(shape, sharder.param_spec(path, shape))
        if path.startswith("blocks/"):
            # blocks/<scan or rem>/<slot>/<rest>
            _, where, slot, rest = path.split("/", 3)
            for i, block in layers(where, slot, shape, got):
                params[f"layers/{i}/{rest}"] = block
        elif path.startswith("encoder/blocks/"):
            # the encoder's stack: one "attn" slot over n_enc_layers groups
            _, _, where, slot, rest = path.split("/", 4)
            for i, block in layers(where, slot, shape, got, 1,
                                   cfg.n_enc_layers):
                params[f"encoder/layers/{i}/{rest}"] = block
        else:
            params[path] = got
    tree = jax.eval_shape(lambda: jm.init_cache(TP_BATCH, TP_LEN))
    for path, shape in leaves(tree):
        where, slot, leaf = path.split("/")
        if leaf != "len":
            got = shard(shape, sharder.cache_spec(path, shape))
            for i, block in layers(where, slot, shape, got):
                cache[f"{i}/{leaf}"] = block
    return params, cache


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the test process's results, rank -> its outputs, the reference's
    compiled argument bytes)."""
    import torch.multiprocessing as mp
    out_dir = str(tmp_path_factory.mktemp("tp_serve"))
    refs = {name: _reference(name) for name in TP_CASES}
    olm = _reference(TP_OLM_CASE, seed=1, n_layers=1)
    drops = _reference("moe_drops", seed=2)
    trees = {name: jax.tree.map(np.asarray, jp) for name, (_, jp) in {
        **refs, "olm": olm, "moe_drops": drops}.items()}
    torch.save(trees, os.path.join(out_dir, "given.pt"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), "JAX_PLATFORMS": "cpu"}
    compiled = subprocess.Popen(
        [sys.executable, "-c", REF_BYTES, os.path.dirname(__file__)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ctx = mp.start_processes(tp_rank, args=(RANKS, free_port(), out_dir),
                             nprocs=RANKS, join=False, start_method="spawn")
    try:
        jm, jp = drops
        served = {n: _reference_serve(n, *refs[n]) for n in TP_CASES}
        mine = {"ref": {n: served[n][0] for n in TP_CASES},
                "memory": {n: served[n][1] for n in MEMORY_CASES},
                "drops": np.asarray(jm.prefill(
                    jp, {"tokens": jnp.asarray(moe_drops_tokens())},
                    jm.init_cache(1, TP_LEN))[0], np.float32),
                "whole": {n: _port_whole_logits(n, trees[n])
                          for n in TP_CASES},
                "shapes": {n: _shard_shapes(n) for n in TP_CASES}}
        while not ctx.join(timeout=600):
            pass
        text, err = compiled.communicate(timeout=600)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        if compiled.poll() is None:
            compiled.kill()
    assert compiled.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(RANKS)]
    return mine, ranks, json.loads(text), trees


def _gathered(ranks, key, name):
    """A (..., B_rank, V_rank) output of every rank put back whole: rank r
    sits at (data r // 2, model r % 2). Where the case's weights are
    replicated, each rank holds its rows (the batch over both axes, r's
    block the r-th) of every column."""
    if tp_config(name).family == "ssm":
        return torch.cat([r[key] for r in ranks], dim=-2).numpy()
    d, m = TP_MESH
    return torch.cat([torch.cat([ranks[i * m + j][key] for j in range(m)],
                                dim=-1) for i in range(d)], dim=-2).numpy()


def _rel(a, b, name):
    """The largest |a - b| over the largest |b|, on the real vocabulary's
    columns (the padding's hold -1e9)."""
    v = tp_config(name).vocab_size
    a, b = a[..., :v], b[..., :v]
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", list(TP_CASES))
def test_local_shapes_are_the_reference_sharders_shards(runs, name):
    _, ranks, _, _ = runs
    params, cache = runs[0]["shapes"][name]
    for r in ranks:
        assert r[f"{name}/params"] == params
        assert r[f"{name}/cache"] == cache


@pytest.mark.parametrize("name", list(TP_CASES))
def test_argument_bytes_equal_the_references_memory_analysis(runs, name):
    _, ranks, compiled, _ = runs
    want = compiled[name]
    for r in ranks:
        args = r[f"{name}/args"]
        assert args["prefill"] + want["len"] == want["prefill"] + \
            want["prefill_unused"]
        assert args["decode"] + want["len"] == want["decode"] + \
            want["decode_unused"]


@pytest.mark.parametrize("name", list(TP_CASES))
def test_logits_match_the_reference(runs, name):
    mine, ranks, _, _ = runs
    got = _gathered(ranks, f"{name}/logits", name)
    want = mine["ref"][name]
    assert got.shape == want.shape
    assert _rel(got, want, name) <= LOGIT_TOL


@pytest.mark.parametrize("name", list(TP_CASES))
def test_the_whole_path_still_matches_the_reference(runs, name):
    mine, _, _, _ = runs
    assert _rel(mine["whole"][name], mine["ref"][name], name) <= LOGIT_TOL


@pytest.mark.parametrize("name", list(TP_CASES))
def test_sharded_init_equals_the_whole_inits_blocks(runs, name):
    for r in runs[1]:
        assert bool(r[f"{name}/init"])


def _column_block(t, rank):
    n = t.shape[-1] // TP_MESH[1]
    c = rank % TP_MESH[1]
    return t[..., c * n:(c + 1) * n]


def test_olm16_column_gemm_is_the_plain_kernels_column_block(runs):
    (x, w), _ = tp_gemm_operands()
    whole = olm_matmul(torch.from_numpy(x), torch.from_numpy(w), n_bits=16)
    for rank, r in enumerate(runs[1]):
        got = r["gemm/col"]
        assert got.dtype == torch.float32
        assert torch.equal(got, _column_block(whole, rank))


def test_olm16_row_gemm_is_within_the_bound(runs):
    _, (x, w) = tp_gemm_operands()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    exact = xt.double() @ wt.double()
    bound = olm_error_bound(xt, wt, n_bits=16).double()
    for r in runs[1]:
        assert float(((r["gemm/row"].double() - exact).abs()
                      / bound).max()) <= 1.0
    # the two ranks along `model` hold the same sum
    assert torch.equal(runs[1][0]["gemm/row"], runs[1][1]["gemm/row"])


def test_olm16_serve_issues_one_kernel_call_a_gemm(runs):
    passes = 1 + len(tp_inputs()[1])
    for r in runs[1]:
        assert int(r["olm/calls"]) == passes * TP_OLM_GEMMS_PER_PASS


def test_olm16_layer0_wq_is_the_single_devices_column_block(runs):
    _, ranks, _, trees = runs
    from repro_torch.convert import params_from_jax
    cfg = dataclasses.replace(tp_config(TP_OLM_CASE), n_layers=1)
    params = params_from_jax(trees["olm"], cfg, device="cpu")
    prompt = torch.from_numpy(tp_inputs()[0])
    h = rmsnorm(params["layers"][0]["norm1"],
                embed(params["embed"], prompt, cfg), cfg.norm_eps)
    for rank, r in enumerate(ranks):
        x, w, out = r["olm/wq"]
        d = rank // TP_MESH[1]
        rows = h[d * 2:(d + 1) * 2].reshape(-1, cfg.d_model)
        assert torch.equal(x, rows)
        whole = olm_matmul(rows, params["layers"][0]["attn"]["wq"],
                           n_bits=16)
        assert torch.equal(out, _column_block(whole, rank))
        assert torch.equal(w, _column_block(
            params["layers"][0]["attn"]["wq"], rank))


def _along_model(ranks, key):
    """Each group of ranks that share a `data` coordinate: their `key`."""
    d, m = TP_MESH
    return [[ranks[i * m + j][key] for j in range(m)] for i in range(d)]


@pytest.mark.parametrize("name", MOE_CASES)
def test_every_rank_along_model_routes_alike(runs, name):
    for group in _along_model(runs[1], f"{name}/plans"):
        # 2 layers a forward pass, a plan a lane
        assert len(group[0]) == 2 * (1 + len(tp_inputs()[1])) * (
            TP_BATCH // TP_MESH[0])
        for plans in group[1:]:
            assert len(plans) == len(group[0])
            assert all(torch.equal(a, b) for a, b in zip(plans, group[0]))


def test_a_prefill_that_drops_matches_the_reference_and_routes_alike(runs):
    mine, ranks, _, _ = runs
    cfg = tp_config("moe_drops")
    TK = MOE_DROPS_TOKENS * cfg.experts_per_token
    for r in ranks:
        assert len(r["moe_drops/plans"]) == cfg.n_layers
        for plan, first in zip(r["moe_drops/plans"],
                               ranks[0]["moe_drops/plans"]):
            assert torch.equal(plan, first)
            # capacity 8 of each expert's 12 assignments: 4 dropped each
            assert int((plan[-TK:] == 0).sum()) == 4 * cfg.n_experts
    for group in _along_model(ranks, "moe_drops/logits"):
        got = torch.cat(group, dim=-1).numpy()
        assert got.shape == mine["drops"].shape
        assert _rel(got, mine["drops"], "moe_drops") <= LOGIT_TOL


@pytest.mark.parametrize("name", MEMORY_CASES)
def test_the_prefills_memory_is_the_references_rows(runs, name):
    """Each rank's memory: its rows of the reference's, whole over
    `model` (the encoder's output for the enc-dec cases)."""
    mine, ranks, _, _ = runs
    want = mine["memory"][name]
    d, m = TP_MESH
    n = TP_BATCH // d
    for r, res in enumerate(ranks):
        got = res[f"{name}/memory"].numpy()
        rows = want[r // m * n:(r // m + 1) * n]
        assert got.shape == rows.shape
        assert float(np.abs(got - rows).max() / np.abs(rows).max()) <= \
            LOGIT_TOL


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).family
                                  in ("vlm", "encdec")])
def test_cross_attention_archs_build_partitioned_steps(arch):
    """As published, on a (1, 2) mesh over a fake world of two ranks:
    this rank's blocks on meta pass the steps' check, the prefill takes
    the frontend's key and the decode the memory (and refuses to go
    without it); a cross layer's wk holds this rank's half of the kv
    heads' columns, the encoder's wq its half of the query heads'."""
    from repro_torch.distributed.train import (MEMORY_KEYS,
                                               init_serve_cache,
                                               init_serve_params)
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    d, Dh = cfg.d_model, cfg.head_dim
    with dryrun.fake_world(2):
        sharder = Sharder(dryrun._meta_mesh(make_abstract_mesh(
            (1, 2), ("data", "model"))), cfg)
        sharder.set_batch(2)
        model = Model(cfg, device="meta")
        params = init_serve_params(model, sharder)
        cache = init_serve_cache(model, sharder, 2, 64)
        assert callable(jit_prefill_step(
            model, sharder, params, ["tokens", MEMORY_KEYS[cfg.family]],
            cache))
        assert callable(jit_decode_step(model, sharder, params, cache,
                                        has_memory=True))
        with pytest.raises(ValueError, match="has_memory=False"):
            jit_decode_step(model, sharder, params, cache, has_memory=False)
        cross = next(layer["cross"] for layer in params["layers"]
                     if "cross" in layer)
        assert tuple(cross["wk"].shape) == (d, cfg.n_kv_heads * Dh // 2)
        assert tuple(cross["wo"].shape) == (cfg.n_heads * Dh // 2, d)
        if cfg.n_enc_layers:
            wq = params["encoder"]["layers"][0]["attn"]["wq"]
            assert tuple(wq.shape) == (d, cfg.n_heads * Dh // 2)


@pytest.mark.parametrize("cache", ["chunks", "paged pool"])
def test_a_partitioned_layer_refuses_chunks_and_a_paged_pool(cache):
    from repro_torch.distributed.partition import Partition
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import attention_apply
    cfg = tp_config(TP_OLM_CASE)
    S = 4 if cache == "chunks" else 1
    x = torch.empty((1, S, cfg.d_model), device="meta")
    pos = torch.zeros((1, S), dtype=torch.int32, device="meta")
    kv = (torch.empty((1, TP_LEN, 1, cfg.head_dim), device="meta"),) * 2
    caches = {"chunks": dict(k=kv[0], v=kv[1]),
              "paged pool": dict(kpool=kv[0], vpool=kv[1],
                                 table=torch.zeros((1, 1), dtype=torch.int32,
                                                   device="meta"))}
    with dryrun.fake_world(2):
        part = Partition(Sharder(dryrun._meta_mesh(make_abstract_mesh(
            (1, 2), ("data", "model"))), cfg))
        with pytest.raises(NotImplementedError, match="not chunks or a "
                           "paged pool"):
            attention_apply({}, cfg, x, pos, DotEngine(),
                            kv_cache=caches[cache],
                            chunked=cache == "chunks", part=part)


@pytest.mark.parametrize("arch,leaf,whole", [
    ("recurrentgemma_9b", "rec/wx", True),
    ("mamba2_130m", "ssm/win", False)])
def test_recurrent_and_ssm_archs_build_partitioned_steps(arch, leaf, whole):
    """As published, on a (1, 2) mesh over a fake world of two ranks:
    this rank's blocks on meta pass the steps' check. RecurrentGemma's
    RG-LRU leaves and state split their w channels over `model`, and a
    whole wx is refused; Mamba2's leaves are whole (the Sharder
    replicates them), its batch and state split over both axes, and a
    leaf of another shape is refused."""
    from repro_torch.distributed.train import (init_serve_cache,
                                               init_serve_params)
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    with dryrun.fake_world(2):
        sharder = Sharder(dryrun._meta_mesh(make_abstract_mesh(
            (1, 2), ("data", "model"))), cfg)
        sharder.set_batch(2)
        model = Model(cfg, device="meta")
        params = init_serve_params(model, sharder)
        cache = init_serve_cache(model, sharder, 2, 64)
        assert callable(jit_prefill_step(model, sharder, params, ["tokens"],
                                         cache))
        assert callable(jit_decode_step(model, sharder, params, cache,
                                        has_memory=False))
        layer = params["layers"][0]
        mixer, name = leaf.split("/")
        shape = tuple(layer[mixer][name].shape)
        if whole:
            w = cfg.rnn_width
            assert shape == (cfg.d_model, w // 2)
            assert tuple(cache[0]["h"].shape) == (2, w // 2)
            assert tuple(cache[0]["conv"].shape) == (2, cfg.conv_width - 1,
                                                     w // 2)
            wrong = (cfg.d_model, w)
        else:
            whole_model = Model(cfg, device="meta").init(0)
            assert shape == tuple(whole_model["layers"][0][mixer][name]
                                  .shape)
            assert tuple(cache[0]["h"].shape)[0] == 1
            wrong = (shape[0], shape[1] // 2)
        layer[mixer][name] = torch.empty(wrong, device="meta")
        with pytest.raises(ValueError, match="this rank's block"):
            jit_prefill_step(model, sharder, params, ["tokens"], cache)


@pytest.mark.parametrize("arch,over,mesh,layout,dims", [
    ("qwen3_moe_235b_a22b", {}, (2, 2), "ep", (1, 1, 1)),
    ("mixtral_8x22b", {}, (2, 2), "tp", (1, 1, 2)),
    # ep asked for, but 6 experts do not divide 4 ranks: the d_ff split
    ("qwen3_moe_235b_a22b", dict(n_experts=6), (1, 4), "tp", (1, 1, 2))])
def test_the_expert_layout_and_data_dims_follow_the_specs(arch, over, mesh,
                                                          layout, dims):
    """Rank 0's Partition on a fake world: the layout read from the
    Sharder's spec of the expert leaves (not from cfg.moe_sharding alone),
    its expert range, and the dim of wg, wu and wd gathered over `data`
    (under ep, wd's is its f)."""
    from repro_torch.distributed.partition import Partition
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(smoke_config(arch), **over)
    with dryrun.fake_world(mesh[0] * mesh[1]):
        part = Partition(Sharder(dryrun._meta_mesh(make_abstract_mesh(
            mesh, ("data", "model"))), cfg))
        assert part.experts_by == layout
        assert part.expert_range() == ((0, cfg.n_experts // mesh[1])
                                       if layout == "ep" else
                                       (0, cfg.n_experts))
        assert tuple(part.expert_data_dim(leaf) for leaf in (
            "wg", "wu", "wd")) == dims


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).family == "moe"])
def test_moe_archs_build_partitioned_steps(arch):
    """As published, on a (1, 2) mesh over a fake world of two ranks:
    this rank's blocks on meta pass the steps' check, and a whole leaf
    does not."""
    from repro_torch.distributed.train import (init_serve_cache,
                                               init_serve_params)
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    with dryrun.fake_world(2):
        sharder = Sharder(dryrun._meta_mesh(make_abstract_mesh(
            (1, 2), ("data", "model"))), cfg)
        sharder.set_batch(2)
        model = Model(cfg, device="meta")
        params = init_serve_params(model, sharder)
        cache = init_serve_cache(model, sharder, 2, 64)
        assert callable(jit_prefill_step(model, sharder, params, ["tokens"],
                                         cache))
        assert callable(jit_decode_step(model, sharder, params, cache,
                                        has_memory=False))
        moe = params["layers"][0]["moe"]
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert tuple(moe["wg"].shape) == ((E // 2, d, f) if
                                          cfg.moe_sharding == "ep" else
                                          (E, d, f // 2))
        params["layers"][0]["moe"]["wd"] = torch.empty(
            (E, f, d), device="meta")
        with pytest.raises(ValueError, match="this rank's block"):
            jit_prefill_step(model, sharder, params, ["tokens"], cache)


def test_a_sharded_engine_and_whole_params_are_refused():
    cfg = tp_config(TP_OLM_CASE)
    sharder = Sharder(make_abstract_mesh((1, 2), ("data", "model")), cfg)
    with pytest.raises(ValueError, match="shards nothing itself"):
        jit_prefill_step(Model(cfg, DotEngine(mesh=object(), shard="n"),
                               device="meta"), sharder, None, ["tokens"],
                         None)


def test_init_hands_each_leaf_to_keep_in_draw_order():
    cfg = tp_config("fsdp_bias")
    model = Model(cfg, device="cpu")
    seen = []

    def keep(path, t):
        seen.append(path)
        return t

    a, b = model.init(5), model.init(5, keep=keep)
    from repro_torch.distributed.sharding import path_leaves
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        path_leaves(a), path_leaves(b)))
    assert sorted(seen) == sorted(p for p, _ in path_leaves(a))
    layer = [p.split("/", 2)[2] for p in seen if p.startswith("layers/0/")]
    assert layer == ["norm1/scale", "attn/wq", "attn/wk", "attn/wv",
                     "attn/wo", "attn/bq", "attn/bk", "attn/bv",
                     "norm2/scale", "mlp/wg", "mlp/wu", "mlp/wd"]
    assert seen[0] == "embed/table" and seen[-1] == "unembed/table"
