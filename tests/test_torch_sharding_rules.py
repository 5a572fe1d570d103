"""The port's Sharder (`distributed/sharding.py`) against the reference's,
shape-only: no process group, nothing allocated.

For every architecture, on the abstract 16x16 and 2x16x16 meshes, every
param and cache leaf of the port (its shapes from `Model` on the meta
device) gets a spec that divides its dims and equals, in its trailing
dims, the reference Sharder's spec of the corresponding reference leaf
(its shapes from `jax.eval_shape`): the port's `layers/<i>/...` leaf is
the reference's `blocks/scan/<slot>/...` leaf of group i // len(pattern),
or a `blocks/rem/<j>/...` leaf, as `convert.py` maps them. Then the batch
specs, the logits spec and the vocab axis over several global batches,
and the FSDP and EP/TP cases of tests/test_sharding_rules.py.

The reference's tree is traced at one pattern group (and one encoder
layer), its remainder layers kept: the leaves' shapes do not depend on
the depth but for the leading group axis, which is set to the full
config's (tracing Qwen3-MoE's 94 layers takes the reference ~50 s).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest

from repro.compat import make_abstract_mesh as jax_abstract_mesh
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import Sharder as JSharder
from repro.distributed.sharding import _path_str
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import P, Sharder, path_leaves
from repro_torch.launch.mesh import (batch_axes, make_abstract_mesh,
                                     make_production_mesh)
from repro_torch.models.model import Model

SHAPES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def sharders(arch, multi_pod, batch=128):
    sizes, names = SHAPES[multi_pod]
    ours = Sharder(make_abstract_mesh(sizes, names), get_config(arch))
    theirs = JSharder(jax_abstract_mesh(sizes, names), jax_get_config(arch))
    if batch is not None:
        ours.set_batch(batch)
        theirs.set_batch(batch)
    return ours, theirs


def norm(spec):
    return P(*tuple(spec))


def ref_leaves(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.__setitem__(_path_str(p), leaf.shape), tree)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """{path: shape} of the reference's param tree at one pattern group
    and one encoder layer."""
    cfg = jax_get_config(arch)
    pat = len(cfg.block_pattern)
    cut = dataclasses.replace(cfg, n_layers=pat + cfg.n_layers % pat,
                              n_enc_layers=min(cfg.n_enc_layers, 1))
    return ref_leaves(jax.eval_shape(
        JModel(cut).init, jax.ShapeDtypeStruct((2,), jnp.uint32)))


def ref_layer_path(rest, i, pattern, n_layers, prefix):
    """(the reference path, its group count or None) for the port's layer
    i of a stack: a scanned leaf has a leading group axis."""
    groups = n_layers // len(pattern)
    if i < groups * len(pattern):
        return f"{prefix}scan/{i % len(pattern)}/{rest}", groups
    return f"{prefix}rem/{i - groups * len(pattern)}/{rest}", None


def ref_param_path(path, cfg):
    parts = path.split("/")
    if parts[0] == "layers":
        return ref_layer_path("/".join(parts[2:]), int(parts[1]),
                              cfg.block_pattern, cfg.n_layers, "blocks/")
    if parts[:2] == ["encoder", "layers"]:
        return ref_layer_path("/".join(parts[3:]), int(parts[2]), ("attn",),
                              cfg.n_enc_layers, "encoder/blocks/")
    return path, None


def assert_divides(spec, shape, sizes, what):
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        size = math.prod(sizes[n] for n in names)
        assert shape[d] % size == 0, (what, shape, spec)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_param_and_cache_specs_divide_and_are_the_references(arch,
                                                             multi_pod):
    ours, theirs = sharders(arch, multi_pod)
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    jm = JModel(jax_get_config(arch))
    ref = ref_params(arch)
    leaves = path_leaves(model.init(0))
    assert len(leaves) >= len(ref)
    for path, leaf in leaves:
        shape = tuple(leaf.shape)
        rpath, groups = ref_param_path(path, cfg)
        lead = 0 if groups is None else 1
        assert ref[rpath][lead:] == shape, (path, rpath)
        rshape = shape if groups is None else (groups, *shape)
        spec = ours.param_spec(path, shape)
        assert len(spec) == len(shape)
        assert spec == norm(theirs.param_spec(rpath, rshape))[lead:], path
        assert_divides(spec, shape, ours.shape, path)
    cache = path_leaves(model.init_cache(128, 4096))
    rcache = ref_leaves(jax.eval_shape(lambda: jm.init_cache(128, 4096)))
    assert cache
    for path, leaf in cache:
        shape = tuple(leaf.shape)
        i, rest = path.split("/", 1)
        rpath, groups = ref_layer_path(rest, int(i), cfg.block_pattern,
                                       cfg.n_layers, "")
        lead = 0 if groups is None else 1
        assert rcache[rpath][lead:] == shape, (path, rpath)
        spec = ours.cache_spec(path, shape)
        assert spec == norm(theirs.cache_spec(rpath, rcache[rpath]))[lead:]
        assert_divides(spec, shape, ours.shape, path)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_logits_and_vocab_specs_are_the_references(arch):
    for multi_pod in (False, True):
        for batch in (None, 128, 16, 2, 3):
            ours, theirs = sharders(arch, multi_pod, batch)
            assert ours.batch_spec() == norm(theirs.batch_spec())
            keys = ("tokens", "mask", "patches")
            assert ours.batch_specs(keys) == {
                k: norm(v) for k, v in theirs.batch_specs(keys).items()}
            assert ours.logits_spec() == norm(theirs.logits_spec())
            assert ours.vocab_axis() == theirs.vocab_axis()
            for seq in (False, True):
                assert ours.activation_spec(seq_sharded=seq) == norm(
                    theirs.activation_spec(seq_sharded=seq))
            assert (ours.dp, ours.data_size, ours.model_size) == (
                theirs.dp, theirs.data_size, theirs.model_size)


def test_meshes_are_the_references():
    from repro.launch.mesh import batch_axes as jax_batch_axes
    for multi_pod, size in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        sizes, names = SHAPES[multi_pod]
        assert (mesh.axis_sizes, mesh.axis_names, mesh.size) == (
            sizes, names, size)
        assert batch_axes(mesh) == jax_batch_axes(jax_abstract_mesh(
            sizes, names))
        with pytest.raises(RuntimeError, match=f"needs {size} ranks"):
            Sharder(mesh, get_config("internlm2_1_8b")).placements(
                ("model", None))
    with pytest.raises(ValueError, match="sizes for"):
        make_abstract_mesh((2, 2), ("data",))


def test_fsdp_shards_large_archs_over_data():
    sharder = Sharder(make_production_mesh(), get_config("qwen1_5_110b"))
    assert sharder.param_spec("layers/0/mlp/wg", (8192, 49152)) == (
        "data", "model")
    small = Sharder(make_production_mesh(), get_config("internlm2_1_8b"))
    assert small.param_spec("layers/0/mlp/wg", (2048, 8192)) == (
        None, "model")


def test_moe_ep_vs_tp_profiles():
    q = get_config("qwen3_moe_235b_a22b")   # 128 experts: EP
    m = get_config("mixtral_8x22b")          # 8 experts < 16: TP-in-expert
    sq = Sharder(make_production_mesh(), q).param_spec(
        "layers/0/moe/wg", (128, 4096, 1536))
    sm = Sharder(make_production_mesh(), m).param_spec(
        "layers/0/moe/wg", (8, 6144, 16384))
    assert sq[-3] == "model"        # experts sharded
    assert sm[-1] == "model"        # d_ff sharded inside experts


def test_ambient_mesh_axes_are_the_references():
    from repro.compat import use_mesh as jax_use_mesh
    from repro.distributed.constraints import dp_axes as jax_dp_axes
    from repro.distributed.constraints import mesh_axes as jax_mesh_axes
    from repro_torch.distributed.constraints import (dp_axes, mesh_axes,
                                                     use_mesh)
    assert (mesh_axes(), dp_axes()) == ({}, ())
    with use_mesh(make_abstract_mesh((1, 1), ("data", "model"))):
        with jax_use_mesh(jax.make_mesh((1, 1), ("data", "model"))):
            assert (mesh_axes(), dp_axes()) == (jax_mesh_axes(),
                                                jax_dp_axes())
        with use_mesh(make_production_mesh(multi_pod=True)):
            assert mesh_axes() == {"pod": 2, "data": 16, "model": 16}
            assert dp_axes() == ("pod", "data")
        assert dp_axes() == ("data",)
    assert (mesh_axes(), dp_axes()) == ({}, ())


def test_spec_trees_follow_the_leaves():
    cfg = get_config("mixtral_8x22b")
    sharder = Sharder(make_production_mesh(), cfg)
    model = Model(cfg, device="meta")

    def at(tree, path):
        for key in path.split("/"):
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        return tree

    for tree, one, many in (
            (model.init(0), sharder.param_spec, sharder.param_specs),
            (model.init_cache(128, 4096), sharder.cache_spec,
             sharder.cache_specs)):
        specs = many(tree)
        for path, leaf in path_leaves(tree):
            assert at(specs, path) == one(path, tuple(leaf.shape)), path
