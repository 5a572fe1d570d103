"""The port's public names against the reference's, module by module: every
public name of a module of `src/repro/` (its `__all__`, else its public
functions and classes, and the public methods of a class both packages
define) is in the port's module of the same path, unless it is listed
below with the reason the port has none. Read from the sources (no
module is imported), so the check costs milliseconds."""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

TPU = "a Pallas kernel, its body or its BlockSpec table: the Hopper kernel " \
      "and its launch plan take its place"

# module -> reason, for reference modules with no port module of that path
NO_MODULE = {
    "compat.py": "JAX version shims; torch needs none",
    "analysis/jaxpr_lint.py": "checks jaxprs; the port checks the SASS of "
                              "its CUDA sources in analysis/sass.py",
    "analysis/vmem.py": "the TPU's VMEM model; the port checks Hopper's "
                        "launch limits in analysis/smem.py",
    "launch/dryrun.py": "the dry run is the last slice of the port",
    "launch/roofline.py": "the dry run is the last slice of the port",
}

# (module, name) -> reason, for public names the port's module lacks
NOT_PORTED = {
    ("kernels/common.py", "decode_stream_inkernel"): TPU,
    ("kernels/common.py", "decode_stream_wide_inkernel"): TPU,
    ("kernels/common.py", "decode_stream_jnp"):
        "the jnp decode; the port's plain one is decode_stream",
    ("kernels/common.py", "decode_stream_wide_jnp"):
        "the jnp decode; the port's plain one is decode_stream_wide",
    ("kernels/common.py", "int64_enabled"):
        "JAX's x64 switch; torch always has int64",
    ("kernels/online_dot/kernel.py", "online_dot_pallas"): TPU,
    ("kernels/online_dot/kernel.py", "lane_tree"): TPU,
    ("kernels/online_dot/kernel.py", "dot_block_shapes"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "olm_matmul_pallas"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "olm_matmul_fused_pallas"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "tile_update"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "fused_tile_update"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "matmul_block_shapes"): TPU,
    ("kernels/online_dot/matmul_kernel.py", "fused_matmul_block_shapes"): TPU,
    ("kernels/online_mul/kernel.py", "online_mul_pallas"): TPU,
    ("kernels/online_mul/kernel.py", "mul_digit_loop"): TPU,
    ("kernels/online_mul/kernel.py", "mul_block_shapes"): TPU,
    ("kernels/tpmm/kernel.py", "tpmm_pallas"): TPU,
    ("kernels/tpmm/kernel.py", "plane_accumulate"): TPU,
    ("kernels/tpmm/kernel.py", "tpmm_block_shapes"): TPU,
    ("kernels/online_dot/ref.py", "oracle_needs_x64"):
        "whether the jnp oracle needs JAX's x64 switch; torch has int64",
    ("kernels/online_dot/tuning.py", "lane_budget"):
        "the TPU's VMEM lane budget; the port's plans are bounded by "
        "matmul_kernel.fits",
    ("kernels/online_mul/ops.py", "online_dot"):
        "a second route to the digit-level dot; the port's is "
        "kernels/online_dot/ops.py::online_dot",
    ("distributed/constraints.py", "constrain"):
        "a GSPMD sharding hint with no eager counterpart (ROADMAP section 3)",
    ("distributed/sharding.py", "Sharder.named"):
        "builds a jax NamedSharding; the port's placements are DTensor's",
    ("distributed/train.py", "TrainState"):
        "a jax pytree type; the port's train state is a plain dict",
    ("models/layers.py", "rmsnorm_init"):
        "the port builds the norm's scale inline (Model.init, block_init)",
    ("models/transformer.py", "stack_init"):
        "the reference's scanned stack; the port keeps a list of layers",
    ("models/transformer.py", "stack_cache_init"):
        "the reference's scanned stack; the port keeps a list of caches",
    ("launch/shapes.py", "input_specs"):
        "used only by the dry run, the last slice of the port",
    ("launch/shapes.py", "cells_for"):
        "used only by the dry run, the last slice of the port",
}


def _names(path: pathlib.Path):
    """(public names, {class: its public methods}) of one module: its
    __all__, else its public defs; plus everything it defines, imports or
    assigns at the top level (what `from module import name` finds)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    exported, defined, classes = None, set(), {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
                    if t.id == "__all__":
                        exported = set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not n.name.startswith("_")}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            defined.update(a.asname or a.name.split(".")[0]
                           for a in node.names)
    public = {n for n in defined if not n.startswith("_")
              and n in {d.name for d in tree.body
                        if isinstance(d, (ast.FunctionDef, ast.ClassDef))}}
    return (exported if exported is not None else public), defined, classes


MODULES = sorted(str(p.relative_to(SRC / "repro"))
                 for p in (SRC / "repro").rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_the_port_has_the_references_public_names(rel):
    port = SRC / "repro_torch" / rel
    if rel in NO_MODULE:
        assert not port.exists(), f"{rel} is ported now: drop it from the list"
        return
    assert port.exists(), f"no port module {rel}"
    want, _, want_classes = _names(SRC / "repro" / rel)
    _, have, have_classes = _names(port)
    missing = sorted(n for n in want if n not in have
                     and (rel, n) not in NOT_PORTED)
    for cls, methods in want_classes.items():
        if cls in have_classes and cls in want:
            missing += sorted(f"{cls}.{m}" for m in methods
                              if m not in have_classes[cls]
                              and (rel, f"{cls}.{m}") not in NOT_PORTED)
    assert missing == [], f"{rel}: the port lacks {missing}"


def test_every_listed_gap_is_still_a_gap():
    # a name ported since it was listed must leave the list
    for (rel, name), reason in NOT_PORTED.items():
        assert reason
        _, have, classes = _names(SRC / "repro_torch" / rel)
        cls, _, method = name.partition(".")
        present = (method in classes.get(cls, set())) if method else (
            name in have)
        assert not present, f"{rel}::{name} is ported now"


def test_the_gaps_this_slice_closed():
    _, have, classes = _names(SRC / "repro_torch" / "core" / "numerics.py")
    assert {"mode_table", "einsum"} <= classes["DotEngine"]
    _, have, _ = _names(SRC / "repro_torch" / "kernels" / "online_dot" /
                        "matmul.py")
    assert "DEFAULT_QUANTIZE" in have
    want, _, _ = _names(SRC / "repro" / "kernels" / "online_dot" /
                        "__init__.py")
    got, _, _ = _names(SRC / "repro_torch" / "kernels" / "online_dot" /
                       "__init__.py")
    assert got == want
