"""Deterministic synthetic token pipeline, host-sharded and restartable
(own copy of `repro/data/synthetic.py`: numpy only, on the port's
`ModelConfig`; its batches are the reference's bit for bit).

Generates a structured token stream (a mixture of Zipfian unigrams and
repeated n-gram motifs so models have something learnable) with:
  * determinism: stream state is (seed, step) — restoring a checkpoint at
    step k reproduces the exact batch k+1, with no data-state file needed;
  * host sharding: each process generates only its slice of the global
    batch (process_index/process_count);
  * frontend stubs: per-batch frame/patch embeddings for encdec/vlm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLMDataset", "make_batches"]


@dataclasses.dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    motif_len: int = 16
    n_motifs: int = 64

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError("global_batch must divide across processes")
        self.local_batch = self.global_batch // self.process_count
        base = np.random.default_rng(self.seed)
        v = self.cfg.vocab_size
        # shared motif table (same on every host)
        self.motifs = base.integers(0, v, size=(self.n_motifs, self.motif_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.process_index)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, S, v = self.local_batch, self.seq_len, self.cfg.vocab_size
        toks = rng.choice(v, size=(B, S), p=self.unigram).astype(np.int32)
        # overwrite random spans with motifs (learnable structure)
        n_spans = max(1, S // (4 * self.motif_len))
        for b in range(B):
            for _ in range(n_spans):
                m = rng.integers(0, self.n_motifs)
                at = rng.integers(0, max(S - self.motif_len, 1))
                toks[b, at:at + self.motif_len] = self.motifs[m]
        out: Dict[str, np.ndarray] = {"tokens": toks}
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def make_batches(cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 seed: int = 0, start_step: int = 0):
    return SyntheticLMDataset(cfg, global_batch, seq_len, seed).iterate(start_step)
