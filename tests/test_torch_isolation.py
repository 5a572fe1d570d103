"""The port stands alone: no module of `src/repro_torch/`, no script of
`probes/`, not `tools/olmlint_torch.py`, no port example
(`examples/*_torch.py`) and not `chip_smoke.py` imports JAX or the JAX
package, and its entry points run on the CUDA card unless the caller asks
for the CPU."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "probes").glob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py"))
         + [ROOT / "tools" / "olmlint_torch.py", ROOT / "chip_smoke.py"])
BANNED = ("jax", "jaxlib", "repro")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Test workers share the machine's cores: one torch thread each keeps
    # their OpenMP pools from spinning against one another.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_port_modules_found():
    names = {p.name for p in FILES}
    assert {"matmul_kernel.py", "engine.py", "chip_smoke.py", "degrade.py",
            "faults.py", "replay.py", "chatglm3_6b.py", "yi_34b.py",
            "qwen1_5_110b.py", "sd.py", "online_add.py", "pipeline.py",
            "inner_product.py", "hwmodel.py", "recurrent.py", "moe.py",
            "recurrentgemma_9b.py", "mamba2_130m.py", "mixtral_8x22b.py",
            "qwen3_moe_235b_a22b.py", "tuning.py", "shapes.py",
            "llama_3_2_vision_11b.py", "seamless_m4t_medium.py",
            "adamw.py", "compression.py", "schedule.py", "synthetic.py",
            "fault.py", "manager.py", "train.py", "tree.py",
            "matmul_sharded.py", "mesh.py", "constraints.py", "sharding.py",
            "collectives.py", "contracts.py", "overflow.py", "registry.py",
            "smem.py", "sass.py", "ast_lint.py", "olmlint_torch.py",
            "quickstart_torch.py", "online_numerics_matmul_torch.py",
            "serve_batched_torch.py", "train_lm_torch.py", "dryrun.py",
            "roofline.py", "dryrun_sweep.py", "partition.py"} <= names


def test_degrade_ladder_resolves_modes_from_the_port_registry(monkeypatch):
    # the ladder checks its rungs against the port's own DotEngine
    # registry, never the reference's
    from repro_torch.core import numerics
    from repro_torch.serving.degrade import DegradeLadder
    lad = DegradeLadder.build(["olm16", "olm16t12"], base_mode="olm16")
    assert lad.ladder == ("olm16", "olm16t12")
    monkeypatch.setattr(numerics.DotEngine, "modes",
                        staticmethod(lambda: ("olm16",)))
    with pytest.raises(ValueError, match="not registered"):
        DegradeLadder.build(["olm16", "olm16t12"], base_mode="olm16")


def test_entry_points_refuse_to_drift_onto_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is real")
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, params)
    ServeEngine(model, params, device="cpu", max_len=16)


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is real")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "internlm2_1_8b", "--smoke", "--requests", "1"])
