"""The port's train CLI (`python -m repro_torch.launch.train`) on the CPU at
smoke size: the reference's printed lines and JSON summary, checkpoints,
--resume at the saved step of the exact data stream, a clean exit on
SIGTERM, --dot-shard on the one-rank mesh and --production-mesh stopping
before its first step."""
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch import train as train_cli

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "mamba2_130m", "--smoke", "--batch", "4", "--seq", "32",
        "--device", "cpu", "--log-every", "1"]
STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3}) "
                       r"lr (\d\.\d\de[+-]\d\d)$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step_lines(text):
    return [m.groups() for m in map(STEP_LINE.match, text.splitlines()) if m]


def test_cli_prints_the_references_lines_and_resumes(tmp_path):
    # the module as a user runs it, in its own process
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert [int(s[0]) for s in step_lines(out.stdout)] == [0, 1, 2, 3]
    summary = json.loads(lines[-1])
    assert sorted(summary) == ["arch", "loss_first", "loss_improved",
                               "loss_last", "steps", "stragglers"]
    assert summary["arch"] == "mamba2-130m" and summary["steps"] == 4
    assert summary["stragglers"] == []
    assert float(step_lines(out.stdout)[0][3]) == 0.0   # lr 0 at step 0
    ckpt = CheckpointManager(tmp_path / "mamba2-130m")
    assert ckpt.all_steps() == [2, 4]
    man = json.loads((tmp_path / "mamba2-130m" / "step_00000004" /
                      "manifest.json").read_text())
    assert man["step"] == 4

    # --resume in process: starts at the saved step, on the stream's batch
    seen = []
    real = SyntheticLMDataset.batch

    def batch(self, step):
        seen.append(step)
        return real(self, step)

    SyntheticLMDataset.batch = batch
    try:
        summary = train_cli.main([*ARGS, "--steps", "6", "--ckpt-every", "2",
                                  "--ckpt-dir", str(tmp_path), "--resume"])
    finally:
        SyntheticLMDataset.batch = real
    assert seen == [4, 5] and summary["steps"] == 2
    assert ckpt.all_steps() == [2, 4, 6]


def test_sigterm_saves_the_next_step_and_exits_cleanly(tmp_path, capsys):
    handler = signal.getsignal(signal.SIGTERM)
    real = SyntheticLMDataset.batch

    def batch(self, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    SyntheticLMDataset.batch = batch
    try:
        summary = train_cli.main([*ARGS, "--steps", "6", "--ckpt-every",
                                  "100", "--ckpt-dir", str(tmp_path)])
    finally:
        SyntheticLMDataset.batch = real
    out = capsys.readouterr().out
    assert "preempted: checkpoint saved, exiting cleanly" in out
    assert summary["steps"] == 3
    ckpt = CheckpointManager(tmp_path / "mamba2-130m")
    assert ckpt.all_steps() == [3]
    # the saved state resumes at step 3
    summary = train_cli.main([*ARGS, "--steps", "4", "--ckpt-every", "100",
                              "--ckpt-dir", str(tmp_path), "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert summary["steps"] == 1
    assert signal.getsignal(signal.SIGTERM) == handler   # handed back


@pytest.mark.parametrize("flag", [["--dot-shard", "n"], ["--production-mesh"]],
                         ids=["dot-shard", "production-mesh"])
def test_mesh_flags_are_refused(flag, tmp_path, capsys, monkeypatch):
    # no longer refused. --dot-shard n trains on the one-rank mesh with
    # every olm GEMM through the sharded front-end; --production-mesh
    # builds the 16x16 specs and stops before the first step, the world
    # lacking its 256 ranks
    if flag[0] == "--production-mesh":
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            train_cli.main([*ARGS, "--steps", "1", "--ckpt-dir",
                            str(tmp_path), *flag])
        out = capsys.readouterr().out
        assert "production mesh {'data': 16, 'model': 16}" in out
        assert not step_lines(out) and not list(tmp_path.iterdir())
        return
    from repro_torch.kernels.online_dot import matmul_sharded
    calls = []

    def counted(*a, **kw):
        calls.append(kw["partition"])
        return real(*a, **kw)

    real = matmul_sharded.olm_matmul_sharded
    monkeypatch.setattr(matmul_sharded, "olm_matmul_sharded", counted)
    summary = train_cli.main([*ARGS[:-2], "--seq", "16", "--batch", "1",
                              "--steps", "1", "--dot-mode", "olm16",
                              "--ckpt-dir", str(tmp_path), *flag])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} over 1 rank(s), backend gloo" in out
    assert summary["steps"] == 1 and np.isfinite(summary["loss_last"])
    assert [float(g) for _, _, g, _ in step_lines(out)] == [0.0]
    assert calls and set(calls) == {"n"}
    assert CheckpointManager(tmp_path / "mamba2-130m").all_steps() == [1]


def test_dot_mode_trains_through_the_digit_gemms(tmp_path, capsys):
    # olm16: the GEMMs' derivative is zero, so the gradient norm is 0;
    # the run completes and checkpoints
    summary = train_cli.main([*ARGS[:-2], "--seq", "16", "--batch", "1",
                              "--steps", "1", "--dot-mode", "olm16",
                              "--ckpt-dir", str(tmp_path)])
    assert summary["steps"] == 1
    lines = step_lines(capsys.readouterr().out)
    assert [float(g) for _, _, g, _ in lines] == [0.0]
    assert CheckpointManager(tmp_path / "mamba2-130m").all_steps() == [1]
    assert np.isfinite(summary["loss_last"])


@pytest.mark.parametrize("flag, device, local_world, cards, want", [
    ("auto", "cpu", 2, 0, "gloo"),
    ("auto", "cuda:0", 1, 1, "gloo"),
    ("auto", "cuda:0", 2, 1, "gloo"),
    ("auto", "cuda:0", 4, 4, "nccl"),
    ("gloo", "cuda:0", 4, 4, "gloo"),
    ("nccl", "cuda:0", 1, 1, "nccl"),
])
def test_backend_follows_the_cards(flag, device, local_world, cards, want,
                                   monkeypatch):
    # NCCL where each rank of the host has a card of its own; gloo where
    # the ranks share a card, run on the CPU or are one; --backend wins
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, why = train_cli.pick_backend(flag, torch.device(device),
                                          local_world)
    assert backend == want and why
