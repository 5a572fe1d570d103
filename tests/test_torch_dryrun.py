"""The port's dry run (`launch/dryrun.py`, `launch/roofline.py`, the stand-ins
of `launch/shapes.py`) against the reference's, on the CPU at smoke sizes.

- `input_specs` and `cells_for` equal to the reference's for every
  architecture and shape (keys, shapes, dtypes, skip reasons), and
  `model_flops` equal too.
- `roofline_terms` on fixed inputs, with the H100 SXM constants.
- The walk's dot FLOPs equal to the reference's `hlo_walk` dot FLOPs of the
  same step compiled by XLA (smoke config, B = 2, S = 64): every family's
  prefill and decode exactly; the gradient at remat="none" against
  `jax.grad` of the reference's `lm_loss` (its sharded `build_train_step`
  fails on this JAX, ROADMAP section 3), exactly for the dense and MoE
  families, and for the SSM within 0.5%, the gap being the backward of the
  SSD's multi-operand einsums, counted op by op below.
- The bytes counter and the live-bytes tracker on hand-counted cases.
- On a fake 2 x 2 world, the collective bytes of one sharded smoke step
  equal to a count from `Sharder.param_specs` and `batch_spec`; those of
  a partitioned decode (the dense and MoE families' serve layout: the KV
  cache over heads and over its length, a sliding-window ring, tp and
  fsdp_tp, experts split by expert and by d_ff) equal to a count from
  the specs, by kind and axis; a partitioned serve cell's per-rank peak
  below the whole layout's, a MoE serve cell's record "partitioned".
- `run_cell` at both production meshes writes a record with the
  reference's keys.

`repro.launch.dryrun` is never imported: it sets XLA_FLAGS for the whole
process when imported. Each fake world is torn down where it is made.
"""
import dataclasses
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import roofline as jroof
from repro.launch import shapes as jshapes
from repro.models.model import Model as JModel
from repro.models.model import lm_loss as jax_lm_loss
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.distributed.sharding import Sharder, spec_leaves
from repro_torch.distributed.train import (build_decode_step,
                                           build_prefill_step,
                                           build_train_step, cast_params,
                                           distribute_state,
                                           init_train_state)
from repro_torch.launch import dryrun, roofline, shapes
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

ARCHS = list_archs()
B, S = 2, 64
# one architecture of each family
FAMILIES = {"dense": "internlm2_1_8b", "moe": "mixtral_8x22b",
            "ssm": "mamba2_130m", "hybrid": "recurrentgemma_9b",
            "encdec": "seamless_m4t_medium", "vlm": "llama_3_2_vision_11b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype_name(dt) -> str:
    return (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


# ------------------------------------------------------------ shapes --

@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    want = jshapes.input_specs(jax_get_config(arch), shape)
    got = shapes.input_specs(get_config(arch), shape)
    assert set(got) == set(want)
    assert dataclasses.asdict(got["case"]) == dataclasses.asdict(want["case"])

    def flat(d):
        return {k: v for k, v in d.items() if k != "case"}

    g = {**flat(got), **got.get("batch", {})}
    w = {**flat(want), **want.get("batch", {})}
    g.pop("batch", None)
    w.pop("batch", None)
    assert set(g) == set(w)
    for k, s in w.items():
        assert g[k].device.type == "meta"
        assert tuple(g[k].shape) == tuple(s.shape), k
        assert _dtype_name(g[k].dtype) == _dtype_name(s.dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_for_matches_reference(arch):
    assert shapes.cells_for(get_config(arch)) == \
        jshapes.cells_for(jax_get_config(arch))


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), shapes.SHAPES[shape]) == \
        jroof.model_flops(jax_get_config(arch), jshapes.SHAPES[shape])


# ---------------------------------------------------------- roofline --

def test_roofline_terms_on_fixed_inputs():
    cost = {"flops": 989e12 * 2.0, "bytes": 3.35e12 * 0.5}
    coll = roofline.collective_bytes(
        {"all-gather@model": {"kind": "all-gather", "axis": "model",
                              "bytes": 450e9, "count": 3},
         "all-reduce@data": {"kind": "all-reduce", "axis": "data",
                             "bytes": 100e9, "count": 5}},
        {"model": roofline.NVLINK_BW, "data": roofline.IB_BW})
    assert coll["per_kind"] == {"all-gather": 450e9, "all-reduce": 100e9}
    assert coll["per_axis"] == {"model": 450e9, "data": 100e9}
    assert coll["count"] == 8 and coll["total_bytes"] == 550e9
    cfg, case = get_config("internlm2_1_8b"), shapes.SHAPES["train_4k"]
    t = roofline.roofline_terms(cost, coll, n_chips=256, cfg=cfg, case=case)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(0.5)
    # 450e9 B at 450 GB/s on NVLink, 100e9 B at 50 GB/s on InfiniBand
    assert t["collective_s"] == pytest.approx(1.0 + 2.0)
    assert t["dominant"] == "collective_s" and t["bound_s"] == t[
        "collective_s"]
    assert t["n_chips"] == 256
    assert t["walk_dot_flops"] == 989e12 * 2.0
    assert t["walk_bytes"] == 3.35e12 * 0.5
    mf = jroof.model_flops(jax_get_config("internlm2_1_8b"),
                           jshapes.SHAPES["train_4k"])
    assert t["model_flops_global"] == mf
    assert t["useful_flops_ratio"] == pytest.approx(mf / 256 / (989e12 * 2))
    # the constants: H100 SXM at 700 W, NVLink 4 each way, one NDR port
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.IB_BW, roofline.HOST_CARDS) == (989e12, 3.35e12, 450e9,
                                                     50e9, 8)
    bare = roofline.roofline_terms({"flops": 0, "bytes": 1.0},
                                   roofline.collective_bytes({}, {}),
                                   n_chips=1)
    assert bare["dominant"] == "memory_s" and "model_flops_global" not in bare


# ----------------------------------------------- FLOPs vs hlo_walk --

def _jax_batch(jc):
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    front = (B, jc.n_frontend_tokens, jc.d_model)
    if jc.family == "encdec":
        batch["frames"] = jnp.zeros(front, jnp.float32)
    if jc.family == "vlm":
        batch["patches"] = jnp.zeros(front, jnp.float32)
    return batch


def _meta_like(tree):
    return {k: torch.empty(tuple(v.shape), device="meta",
                           dtype=getattr(torch, _dtype_name(v.dtype)))
            for k, v in tree.items()}


def _hlo_dot_flops(fn, *args) -> float:
    return jroof.hlo_walk(jax.jit(fn).lower(*args).compile().as_text())[
        "dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_walk_flops_equal_hlo_walk(family, kind):
    arch = FAMILIES[family]
    jc, tc = jax_smoke_config(arch), smoke_config(arch)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(tc, device="meta")
    params = model.init(0)
    batch = _jax_batch(jc)
    if kind == "prefill":
        want = _hlo_dot_flops(jm.prefill, jp, batch, jm.init_cache(B, S))
        got = roofline.walk(build_prefill_step(model), params,
                            _meta_like(batch), model.init_cache(B, S))
    else:
        tok = jnp.zeros((B,), jnp.int32)
        mem = (jnp.zeros((B, jc.n_frontend_tokens, jc.d_model),
                         jc.compute_dtype)
               if jc.family in ("encdec", "vlm") else None)
        want = _hlo_dot_flops(jm.decode_step, jp, tok, tok,
                              jm.init_cache(B, S), mem)
        ttok = torch.empty((B,), dtype=torch.int32, device="meta")
        tmem = None if mem is None else torch.empty(
            tuple(mem.shape), dtype=tc.cdtype, device="meta")
        got = roofline.walk(build_decode_step(model), params, ttok, ttok,
                            model.init_cache(B, S), tmem)
    assert want > 0
    assert got["flops"] == want


def _ssd_backward_gap(cfg) -> int:
    """The dot FLOPs of the reference's gradient that the port's has not,
    a step at (B, S): in each SSD layer, XLA transposes the pairwise steps
    of three multi-operand einsums that multiply without contracting (an
    elementwise product, which XLA keeps as a dot_general) into
    dot_generals whose every dim but the contracted one is batched, where
    torch's autograd takes a mul and a sum (no matmul):
      2 of 2*B*c*h*l*s  in  bchls,bcls,bcsh,bcshp->bclhp  (y_diag),
      1 of 2*B*c*h*l*p  in  bchl,bclh,bcln,bclhp->bchpn   (states),
      2 of 2*B*c*l*h*n  in  bcln,bchl,bchpn->bclhp        (y_off),
    with c chunks of l = s = ssm_chunk positions, h heads of p channels
    and n state dims."""
    l = cfg.ssm_chunk
    c, h = S // l, cfg.ssm_nheads
    p, n = cfg.ssm_headdim, cfg.ssm_state
    per_layer = 2 * (2 * B * c * h * l * l) + 2 * B * c * h * l * p + \
        2 * (2 * B * c * l * h * n)
    return cfg.layer_kinds.count("ssm") * per_layer


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mixtral_8x22b",
                                  "mamba2_130m"])
def test_gradient_flops_against_jax_grad(arch):
    jc, tc = jax_smoke_config(arch), smoke_config(arch)
    assert jc.remat == tc.remat == "none"
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    want = _hlo_dot_flops(jax.grad(lambda p, b: jax_lm_loss(jm, p, b)[0]),
                          jp, batch)
    model = Model(tc, device="meta")
    got = roofline.walk(build_train_step(model), init_train_state(model),
                        _meta_like(batch))["flops"]
    if tc.family == "ssm":
        assert want - got == _ssd_backward_gap(tc)
        assert abs(got - want) / want < 0.005
    else:
        assert got == want


# --------------------------------------------- bytes and live bytes --

def test_a_matmul_counts_its_operands_and_result():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    w = roofline.walk(torch.matmul, a, b)
    assert w["flops"] == 2 * 64 * 32 * 16
    assert w["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert w["bytes_per_device"] == {"argument": (2048 + 512) * 4,
                                     "output": 1024 * 4, "temp": 0,
                                     "peak": (2048 + 512 + 1024) * 4}


def test_a_view_counts_nothing_and_its_storage_once():
    a = torch.empty(64, 32, device="meta")

    def views(x):
        y = x.view(32, 64).t()
        return y, y.reshape(64, 32), x.expand(2, 64, 32), x.detach(), \
            x.narrow(0, 1, 8)

    w = roofline.walk(views, a)
    assert w["bytes"] == 0 and w["flops"] == 0
    assert w["bytes_per_device"] == {"argument": 8192, "output": 0,
                                     "temp": 0, "peak": 8192}
    # empty counts no bytes, but holds its storage
    e = roofline.walk(lambda x: torch.empty_like(x), a)
    assert e["bytes"] == 0 and e["bytes_per_device"]["peak"] == 2 * 8192


def test_a_freed_temporary_leaves_the_live_bytes():
    a = torch.empty(64, 32, device="meta")

    def step(x):
        y = x * 2.0            # 8192 B, dead after the sum
        s = y.sum()            # 4 B, held in 512
        del y
        z = x + s              # 8192 B: reuses y's room
        return z

    w = roofline.walk(step, a)
    assert w["bytes"] == (8192 * 2) + (8192 + 4) + (8192 + 4 + 8192)
    assert w["bytes_per_device"] == {"argument": 8192, "output": 8192,
                                     "temp": 512, "peak": 8192 * 2 + 512}


def test_meta_walk_equals_the_same_walk_on_cpu():
    cfg = smoke_config("mixtral_8x22b")
    counts = []
    for dev in ("meta", "cpu"):
        model = Model(cfg, device=dev)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device=dev)}
        counts.append(roofline.walk(build_train_step(model),
                                    init_train_state(model), batch))
    for key in ("flops", "bytes", "bytes_per_device"):
        assert counts[0][key] == counts[1][key], key


def test_eval_shape_tree_gives_the_shapes_of_a_run():
    cfg = smoke_config("internlm2_1_8b")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.zeros((B, S), dtype=torch.int32)
    want = model.forward(params, {"tokens": tokens})
    meta = Model(cfg, device="meta")
    got = dryrun.eval_shape_tree(
        lambda p, t: meta.forward(p, {"tokens": t}), params, tokens)
    assert [t.device.type for t in got] == ["meta", "meta"]
    assert [(tuple(g.shape), g.dtype) for g in got] == [
        (tuple(w.shape), w.dtype) for w in want]


# ------------------------------------------------------ fake world --

def _hand_count(cfg, sharder, params):
    """(bytes by kind and axis) of one sharded step, from the specs: each
    leaf, cast as the forward runs it, gathered whole axis by axis (inner
    axis of a dim first), every result counted; each whole f32 gradient
    and the three scalar metrics summed over each batch axis of size > 1
    (module docstring of distributed/train.py)."""
    size = sharder.shape
    out = {}

    def add(kind, axis, n):
        out[(kind, axis)] = out.get((kind, axis), 0) + n

    whole = cast_params(params, cfg)
    specs = spec_leaves(sharder.param_specs(params), params)
    for leaf, spec in zip(tree_leaves(whole), specs):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            for a in axes:
                shape[d] //= size[a]
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            for a in reversed(axes):
                if size[a] > 1:
                    shape[d] *= size[a]
                    add("all-gather", a,
                        math.prod(shape) * leaf.element_size())
    bax = sharder.batch_spec()[0]
    bax = (bax,) if isinstance(bax, str) else tuple(bax or ())
    for a in bax:
        if size[a] > 1:
            add("all-reduce", a, sum(p.numel() * 4
                                     for p in tree_leaves(params)) + 3 * 4)
    return out


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen1_5_110b"])
def test_collective_bytes_of_a_sharded_step_on_a_fake_2x2_world(arch):
    cfg = smoke_config(arch)
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        model = Model(cfg, device="meta")
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(4)
        params = model.init(0)
        want = _hand_count(cfg, sharder, params)
        state = distribute_state(sharder, init_train_state(model))
        batch = {"tokens": torch.empty((4, S), dtype=torch.int32,
                                       device="meta")}
        w = roofline.walk(build_train_step(model, sharder), state, batch,
                          mesh=mesh)
        links = roofline.axis_links(mesh)
    got = {(r["kind"], r["axis"]): r["bytes"]
           for r in w["collectives"].values()}
    assert got == want
    assert ("all-gather", "model") in got and ("all-reduce", "data") in got
    if cfg.sharding_profile == "fsdp_tp":
        assert ("all-gather", "data") in got
    # four ranks on one host of eight cards: NVLink on both axes
    assert links == {"data": roofline.NVLINK_BW, "model": roofline.NVLINK_BW}


def _hand_count_decode(cfg, B):
    """{(kind, axis): bytes} of one partitioned decode step of `cfg` on a
    (data 2, model 2) mesh, from the specs: each collective's per-rank
    result bytes."""
    from repro_torch.distributed.sharding import path_leaves
    from repro_torch.distributed.train import block_shape
    sizes = {"data": 2, "model": 2}
    sharder = Sharder(make_abstract_mesh((2, 2), ("data", "model")), cfg)
    sharder.set_batch(B)
    if sharder.replicated:
        # every weight whole on every rank, the batch and cache split by
        # rows: nothing to exchange
        return {}
    rows = B // 2
    d, Dh, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    n_attn = cfg.layer_kinds.count("attn")
    n_rec = cfg.layer_kinds.count("rec")
    out = {}

    def add(kind, axis, n):
        out[(kind, axis)] = out.get((kind, axis), 0) + n

    # the embedding's sum, then each layer's wo partials and its wd
    # partials or, with experts, its one combine of (rows, 1, d), in f32
    add("all-reduce", "model", rows * d * 4 * (1 + 2 * cfg.n_layers))
    if n_rec:
        # each RG-LRU layer's u, gathered whole for the gates' products,
        # in the compute dtype
        add("all-gather", "model", n_rec * rows * cfg.rnn_width
            * cfg.cdtype.itemsize)
    if Hkv % 2:
        # the cache over its length: k, v and q gathered whole, the
        # partial softmax's largest score and its sums
        add("all-gather", "model", n_attn * rows * Dh * 2
            * (2 * Hkv + H))
        add("all-reduce", "model", n_attn * rows * H * (Dh + 2) * 4)
    if cfg.sharding_profile == "fsdp_tp":
        # the embedding: every data rank's ids (int64), then the rows each
        # rank looked up on its columns, in the compute dtype
        add("all-gather", "data", 2 * rows * 8
            + 2 * rows * d * cfg.cdtype.itemsize)
        # each weight whole over "data" for its GEMM or, an expert leaf,
        # its einsum (the head's table, tied or not; the router is
        # replicated)
        whole = dict(path_leaves(Model(cfg, device="meta").init(0)))
        for path in [p for p in whole if p != "final_norm/scale"
                     and not p.endswith("norm1/scale")
                     and not p.endswith("norm2/scale")
                     and "/b" not in p
                     and (p != "embed/table" or cfg.tie_embeddings)]:
            shape = tuple(whole[path].shape)
            spec = sharder.param_spec(path, shape)
            if "data" in spec:
                add("all-gather", "data", 2 * math.prod(block_shape(
                    shape, [a if a == "model" else None for a in spec],
                    sizes)))
    return out


@pytest.mark.parametrize("arch,kv", [("internlm2_1_8b", 2),
                                     ("internlm2_1_8b", 1),
                                     ("qwen1_5_110b", 2), ("yi_34b", 1),
                                     ("qwen3_moe_235b_a22b", 2),
                                     ("mixtral_8x22b", 2),
                                     ("mixtral_8x22b", 1),
                                     ("recurrentgemma_9b", 1),
                                     ("mamba2_130m", 2)])
def test_partitioned_decode_collectives_equal_a_count_from_the_specs(arch,
                                                                    kv):
    cfg = dataclasses.replace(smoke_config(arch), n_kv_heads=kv)
    case = shapes.ShapeCase("t", 64, 4, "decode")
    counts, coll, _ = dryrun.walk_cell(
        cfg, case, make_abstract_mesh((2, 2), ("data", "model")))
    got = {(r["kind"], r["axis"]): r["bytes"]
           for r in counts["collectives"].values()}
    assert got == _hand_count_decode(cfg, 4)
    assert coll["total_bytes"] == sum(got.values())


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_partitioned_cells_peak_is_below_the_whole_layouts(kind):
    cfg = smoke_config("yi_34b")
    case = shapes.ShapeCase("t", 64, 4, kind)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    peaks = {layout: dryrun.walk_cell(cfg, case, mesh, layout)[0][
        "bytes_per_device"]["peak"] for layout in ("partitioned", "whole")}
    assert peaks["partitioned"] < peaks["whole"]
    assert dryrun.serve_layout(cfg) == "partitioned"
    assert dryrun.serve_layout(smoke_config("mixtral_8x22b")) == \
        "partitioned"
    assert dryrun.serve_layout(smoke_config("recurrentgemma_9b")) == \
        "partitioned"
    assert dryrun.serve_layout(smoke_config("llama_3_2_vision_11b")) == \
        "partitioned"


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "llama_3_2_vision_11b"])
def test_a_train_cell_walks_partitioned_below_the_whole(arch):
    """A train cell walks `jit_train_step` by default: the same walk as
    the partitioned layout asked for by name, with reduce-scatters over
    `data` under fsdp_tp, and a peak below the whole layout's (every param
    gathered whole in bf16, whole f32 gradients)."""
    cfg = smoke_config(arch)
    case = shapes.ShapeCase("t", 64, 4, "train")
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    walks = {layout: dryrun.walk_cell(cfg, case, mesh, layout)[0]
             for layout in (None, "partitioned", "whole")}
    peaks = {k: w["bytes_per_device"]["peak"] for k, w in walks.items()}
    assert peaks[None] == peaks["partitioned"] < peaks["whole"]
    assert walks[None]["flops"] == walks["partitioned"]["flops"]
    kinds = {(r["kind"], r["axis"])
             for r in walks["partitioned"]["collectives"].values()}
    assert ("all-reduce", "model") in kinds
    assert (("reduce-scatter", "data") in kinds) == (
        cfg.sharding_profile == "fsdp_tp")
    assert dryrun.serve_layout(cfg) == "partitioned"


def _partitioned_below_the_whole(tmp_path, monkeypatch, arch):
    """A decode_32k cell of `arch` at smoke width: its record walks the
    partitioned layout, sums over `model`, and peaks below the whole
    layout's walk of the same cell."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod=False,
                          out_dir=tmp_path)
    assert rec["layout"] == "partitioned" and "serve" not in rec
    assert rec["collectives"]["per_kind"]["all-reduce"] > 0
    whole, _, _ = dryrun.walk_cell(
        smoke_config(arch), shapes.SHAPES["decode_32k"],
        make_abstract_mesh((16, 16), ("data", "model")), "whole")
    assert rec["bytes_per_device"]["peak"] < whole["bytes_per_device"][
        "peak"]


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "qwen3_moe_235b_a22b"])
def test_a_moe_serve_cells_record_is_partitioned_below_the_whole(
        tmp_path, monkeypatch, arch):
    _partitioned_below_the_whole(tmp_path, monkeypatch, arch)


@pytest.mark.parametrize("arch", ["llama_3_2_vision_11b",
                                  "seamless_m4t_medium"])
def test_a_cross_attention_serve_cells_record_is_partitioned_below_the_whole(
        tmp_path, monkeypatch, arch):
    """The decode takes this rank's rows of the memory back."""
    _partitioned_below_the_whole(tmp_path, monkeypatch, arch)


def test_fake_world_refuses_an_existing_group_and_goes_with_its_block():
    import torch.distributed as dist
    with dryrun.fake_world(8):
        assert dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="exists already"):
            with dryrun.fake_world(8):
                pass
    assert not dist.is_initialized()


def test_fake_world_raises_without_the_fake_backend(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        with dryrun.fake_world(4):
            pass


# -------------------------------------------------------- run_cell --

REF_KEYS = {"arch", "shape", "mesh", "skipped", "microbatches",
            "bytes_per_device", "flops", "bytes_accessed", "collectives",
            "roofline"}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "n_chips", "dominant",
             "model_flops_global", "useful_flops_ratio"}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_writes_the_references_record(tmp_path, monkeypatch, shape,
                                               multi_pod):
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    rec = dryrun.run_cell("internlm2_1_8b", shape, multi_pod=multi_pod,
                          out_dir=tmp_path)
    mesh = "2x16x16" if multi_pod else "16x16"
    assert rec["mesh"] == mesh and not rec["skipped"]
    assert REF_KEYS | {"walk_s"} <= set(rec)
    assert set(rec["bytes_per_device"]) == {"argument", "output", "temp",
                                            "peak"}
    assert ROOF_KEYS <= set(rec["roofline"])
    n = 512 if multi_pod else 256
    assert rec["roofline"]["n_chips"] == n
    assert rec["flops"] > 0 and rec["bytes_per_device"]["peak"] > 0
    if shape == "train_4k":
        # the partitioned train step: the row-parallel and vocab-parallel
        # sums over "model" and the gradients' sums over the batch axes;
        # k and v gathered over "model" (2 smoke kv heads do not divide
        # its 16 ranks), their gradients reduce-scattered back
        assert rec["layout"] == "partitioned"
        assert rec["collectives"]["per_kind"].keys() == {
            "all-gather", "all-reduce", "reduce-scatter"}
        assert rec["collectives"]["link_bw"]["model"] == roofline.IB_BW
    else:
        # the dense family's partitioned decode: the row-parallel sums and
        # the vocab-parallel embedding over "model"
        assert rec["layout"] == "partitioned" and "serve" not in rec
        assert rec["collectives"]["per_axis"].keys() == {"model"}
        assert rec["collectives"]["per_kind"]["all-reduce"] > 0
    saved = json.loads((tmp_path / f"internlm2_1_8b__{shape}__{mesh}.json")
                       .read_text())
    assert saved["flops"] == rec["flops"]
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_run_cell_skips_as_the_reference_does(tmp_path):
    rec = dryrun.run_cell("internlm2_1_8b", "long_500k", multi_pod=False,
                          out_dir=tmp_path)
    ok, why = jshapes.applicable(jax_get_config("internlm2_1_8b"),
                                 "long_500k")
    assert rec == {"arch": "internlm2_1_8b", "shape": "long_500k",
                   "mesh": "16x16", "skipped": True, "skip_reason": why}
    assert not ok


def test_the_cli_prints_the_peak_against_the_card(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    dryrun.main(["--arch", "mamba2_130m", "--shape", "decode_32k",
                 "--both-meshes", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, mesh in zip(lines, ("16x16", "2x16x16")):
        assert line.startswith(f"OK   mamba2_130m x decode_32k x {mesh}: "
                               "peak ")
        assert "GB/rank of 80 GB (fits)" in line
