"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc into plain-C shared
libraries and load them with ctypes.

Each source is compiled for sm_90a at first use into `build/kernels/` at
the root of the checkout (listed in .gitignore), under a directory keyed
by a hash of the source, every shared header (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Several sources are compiled by parallel nvcc processes
started together. No PyTorch header is included: a plain C interface
keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "Built", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math and no FTZ: the kernels are held bit for bit against
# IEEE float32 arithmetic. -Xptxas -v reports registers, shared memory and
# spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: library path, compiler log, build seconds
    (0.0 when an earlier build was reused)."""
    source: str
    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{key}" / f"lib{stem}.so"


def build(sources: Sequence[str]) -> Dict[str, Built]:
    """Compile every source not built yet, all nvcc processes started
    together; raise with the compiler's output if any build fails."""
    out: Dict[str, Built] = {}
    running = {}
    for source in sources:
        lib = _target(source)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[source] = Built(source, lib, log.read_text()
                                if log.exists() else "", 0.0)
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[source] = (proc, lib, tmp, time.monotonic())
    failed = []
    for source, (proc, lib, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[source] = Built(source, lib, log, seconds)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build([source])[source].path))
    return _LOADED[source]
