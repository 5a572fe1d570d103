"""Fault-tolerant checkpointing: atomic, keep-K, async (port of
`repro/checkpoint/manager.py`).

Layout, the reference's:
  <dir>/step_00000100.tmp/...   (written first)
  <dir>/step_00000100/          (atomic rename on completion)
      manifest.json             step, tree structure, n_leaves, shapes,
                                dtypes
      shard_0.npz               leaf_{i}, in flattened tree order

Properties:
  * atomicity: a crash mid-write never corrupts the latest checkpoint
    (readers only ever see fully renamed directories);
  * keep-K garbage collection;
  * async save (a background thread); every leaf is copied to the host
    before the thread starts, so the next step cannot change a tensor
    while it is written;
  * a bf16 leaf, which has no numpy dtype, is stored as its 16-bit
    pattern with "bfloat16" in the manifest and restored to bf16;
  * the data pipeline's state is implicit: the synthetic pipeline is keyed
    by (seed, step), so restoring `step` resumes the exact stream;
  * a sharded state (DTensor leaves) is saved whole: every rank calls
    `save`, the leaves are gathered and copied to the host, and rank 0
    writes them (in the background thread, as above); the ranks meet at
    a barrier once the write is done, in the next `save`, `wait` or
    `restore`, which every rank calls;
  * elastic restore: `restore(shardings=)` places each whole leaf onto
    the mesh and placements given, which need not be those it was saved
    from.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_str, tree_unflatten

__all__ = ["CheckpointManager"]

# torch dtypes numpy lacks, stored as a same-width integer bit pattern
_BITS = {torch.bfloat16: torch.int16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.to("cpu", copy=True).numpy()


def _from_host(a: np.ndarray, dtype_name: str, like: torch.Tensor
               ) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    saved = getattr(torch, dtype_name)
    if saved in _BITS:
        t = t.view(saved)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        # a sharded save's ranks still to meet once it is written
        self._barrier = False

    # ----------------- save -----------------
    def save(self, step: int, tree: Any, *, block: bool = False) -> None:
        leaves, treedef = tree_flatten(tree)
        sharded = any(_is_dtensor(l) for l in leaves)
        if sharded:
            from repro_torch.distributed.collectives import gather_dtensor
            leaves = [gather_dtensor(l) if _is_dtensor(l) else l
                      for l in leaves]
        host = [(_to_host(l), _dtype_name(l.dtype)) for l in leaves]
        desc = tree_str(tree)
        self.wait()  # one in-flight save at a time
        writes = True
        if sharded:
            import torch.distributed as dist
            self._barrier = True
            writes = dist.get_rank() == 0
        if not (self.async_save and not block):
            if writes:
                self._write(step, host, desc)
            self.wait()
        elif writes:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, desc))
            self._thread.start()

    def wait(self):
        """Until the last save is on disk (on every rank of a sharded
        save)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, leaves, desc: str) -> None:
        name = f"step_{step:08d}"
        tmp = self.dir / (name + ".tmp")
        final = self.dir / name
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "treedef": desc,
            "n_leaves": len(leaves),
            "leaves": [{"shape": list(a.shape), "dtype": dt}
                       for a, dt in leaves],
        }
        np.savez(tmp / "shard_0.npz",
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(leaves)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------- restore -----------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of `tree_like`, each leaf on the
        device and in the dtype of `tree_like`'s leaf. `shardings`, a tree
        of tree_like's structure whose leaves have a `mesh` and
        `placements` (distributed.sharding.NamedSharding) or are None,
        places each whole leaf with `distribute_tensor` (a DTensor; every
        rank keeps its block): a mesh of another shape than the one the
        state was saved from is elastic re-sharding on load."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        leaves, treedef = tree_flatten(tree_like)
        manifest = json.loads((path / "manifest.json").read_text())
        n = manifest["n_leaves"]
        if n != len(leaves):
            raise ValueError(
                f"checkpoint has {n} leaves, target structure has {len(leaves)}")
        with np.load(path / "shard_0.npz") as data:
            restored = [_from_host(data[f"leaf_{i}"], meta["dtype"], like)
                        for i, (meta, like) in enumerate(
                            zip(manifest["leaves"], leaves))]
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            restored = [r if s is None else distribute_tensor(
                r, s.mesh, s.placements, src_data_rank=None)
                for r, s in zip(restored, _sharding_leaves(shardings,
                                                           treedef))]
        return tree_unflatten(treedef, restored)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _sharding_walk(node, spec, out) -> None:
    # a module function, not a closure: see repro_torch/tree.py
    if isinstance(spec, dict):
        for k in spec:
            _sharding_walk(node[k], spec[k], out)
    elif isinstance(spec, (list, tuple)):
        for n, s in zip(node, spec):
            _sharding_walk(n, s, out)
    elif spec is not None:
        out.append(node)


def _sharding_leaves(shardings, treedef) -> list:
    """The leaves of `shardings` in treedef's order, a None leaf kept (a
    None leaf of the state's structure is an empty subtree there)."""
    out: list = []
    _sharding_walk(shardings, treedef, out)
    return out
