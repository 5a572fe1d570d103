"""Continuous-batching serving engine with a paged KV cache (port of
`repro/serving/engine.py`, the core serving path).

A fixed pool of `slots` decode lanes shares one decode step; a request
queue feeds empty lanes.

  * Prefill is GEMM-shaped: waiting requests are batched together, their
    prompts right-padded to a shared pow2 length bucket and the batch row
    count padded to a pow2 bucket. Per-lane `last_index` picks each
    prompt's real final position out of the padded rows.
  * Decode stays GEMV-shaped: one token per lane per step, greedy.

KV memory defaults to the paged layout (`kv_layout="paged"`): each layer
holds a block pool plus per-lane block tables, so residency scales with
live tokens instead of `slots * max_len`, and finished lanes return their
blocks to the free list at once. Block 0 is the shared trash block. The
contiguous layout (`kv_layout="contiguous"`) is kept as the reference the
paged one is held against token for token.

Finished lanes (EOS, max_new_tokens, max_len) are recycled immediately.
When a decode step finds the block pool dry, the lane finishes with
`finish_reason="cache_full"`.

Not ported yet (later slices): deadlines, bounded admission, preemption
with recompute, the degrade ladder, quality tiers, chunked prefill, the
fault surfaces and the EngineSpec front door.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import TRASH_BLOCK, paged_scatter_rows
from repro_torch.models.model import Model, resolve_device
from .report import ServeReport

__all__ = ["Request", "ServeEngine"]


def _pow2_bucket(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, math.ceil(math.log2(max(1, n)))))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_queue: float = 0.0                # seconds waited before prefill
    finish_reason: Optional[str] = None  # eos | length | max_len | cache_full


class ServeEngine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 512, dot_mode: Optional[str] = None,
                 kv_layout: str = "paged", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_bucket_min: int = 8, device=None):
        """`device` names where the engine serves (CUDA unless given) and
        must be the model's device. `dot_mode` serves the same weights
        under another registered DotEngine mode."""
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} but the model lives on "
                             f"{model.device}")
        if dot_mode is not None and dot_mode != model.eng.mode:
            model = Model(model.cfg, dataclasses.replace(model.eng,
                                                         mode=dot_mode),
                          device=model.device)
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.model = model
        self.params = params
        self.device = dev
        self.slots = slots
        self.max_len = max_len
        self.prefill_bucket_min = prefill_bucket_min
        self.kv_layout = kv_layout
        self.kv_block_size = kv_block_size
        self.counters: Counter = Counter()
        self._table: Optional[np.ndarray] = None
        self._table_dirty = False
        self._owner: Dict[int, int] = {}
        self._free_set: set = set()
        self.blocks_peak_used = 0
        if kv_layout == "paged":
            bs = kv_block_size
            if bs < 1:
                raise ValueError("kv_block_size must be >= 1")
            mbl = -(-max_len // bs)         # blocks per lane at max_len
            self.blocks_per_lane = mbl
            if kv_blocks is None:
                # every lane can reach half depth at once, any single lane
                # full max_len, plus the trash block
                kv_blocks = 1 + max(mbl, -(-slots * mbl // 2))
            if kv_blocks < 2:
                raise ValueError("kv_blocks must be >= 2 (trash + 1 usable)")
            self.kv_blocks = kv_blocks
            self.cache = model.init_cache(
                slots, max_len,
                paged={"num_blocks": kv_blocks, "block_size": bs})
            self._table_dev = self.cache[0]["table"]  # shared by all layers
            # host-side allocator: ids 1..kv_blocks-1 are usable (0 is the
            # trash block); LIFO free list
            self._free: List[int] = list(range(kv_blocks - 1, 0, -1))
            self._free_set = set(self._free)
            self._owned: Dict[int, List[int]] = {s: [] for s in range(slots)}
            self._table = np.full((slots, mbl), TRASH_BLOCK, np.int32)
        else:
            self.kv_blocks = 0
            self.blocks_per_lane = 0
            self.cache = model.init_cache(slots, max_len)
        self.active: Dict[int, Request] = {}       # slot -> request
        self.pos = np.zeros((slots,), np.int32)
        self.last_tok = np.zeros((slots,), np.int32)
        self.queue: Deque[Request] = deque()

    # ------------- client API -------------
    def submit(self, req: Request) -> bool:
        P = len(req.prompt)
        if P < 1 or P > self.max_len - 1:
            raise ValueError(
                f"prompt length {P} outside [1, max_len-1={self.max_len - 1}]")
        req.t_submit = time.monotonic()
        self.queue.append(req)
        return True

    def run(self, *, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.step(done)
            steps += 1
        return done

    def step(self, done: List[Request]) -> None:
        """One scheduler iteration: admit waiting requests through one
        batched prefill, then one decode step for every active lane."""
        self._schedule_prefill(done)
        if self.active:
            self._decode_step(done)

    # ------------- block allocator (paged layout) -------------
    @property
    def free_blocks(self) -> int:
        return len(self._free) if self.kv_layout == "paged" else 0

    def _alloc_blocks(self, slot: int, n: int) -> bool:
        """Give `slot` its next n blocks, all or nothing; every id the free
        list yields is checked (in range, not owned) before it can reach
        a lane table."""
        if len(self._free) < n:
            return False
        for _ in range(n):
            bid = self._free.pop()
            self._free_set.discard(bid)
            if not 1 <= bid < self.kv_blocks or bid in self._owner:
                raise RuntimeError(
                    f"block-allocator integrity: free list yielded block "
                    f"{bid} (usable range [1, {self.kv_blocks}), owner "
                    f"{self._owner.get(bid)!r}) - free list corrupted")
            self._owner[bid] = slot
            self._table[slot, len(self._owned[slot])] = bid
            self._owned[slot].append(bid)
        self._table_dirty = True
        used = (self.kv_blocks - 1) - len(self._free)
        self.blocks_peak_used = max(self.blocks_peak_used, used)
        return True

    def _free_slot_blocks(self, slot: int) -> None:
        owned = self._owned[slot]
        if not owned:
            return
        for bid in owned:
            if bid in self._free_set or self._owner.get(bid) != slot:
                raise RuntimeError(
                    f"double-free: lane {slot} freeing block {bid} - "
                    "allocator state corrupted")
            del self._owner[bid]
        self._free.extend(reversed(owned))
        self._free_set.update(owned)
        self._owned[slot] = []
        self._table[slot, :] = TRASH_BLOCK
        self._table_dirty = True

    def _integrity_ok(self) -> bool:
        """Usable blocks partition into free and owned with no duplicates,
        and every lane table row is its owned list then trash padding."""
        if self.kv_layout != "paged":
            return True
        owned_all = [b for blks in self._owned.values() for b in blks]
        free, owned = set(self._free), set(owned_all)
        if len(free) != len(self._free) or len(owned) != len(owned_all):
            return False
        if free & owned or free | owned != set(range(1, self.kv_blocks)):
            return False
        mbl = self.blocks_per_lane
        return all(
            list(self._table[s]) == self._owned[s]
            + [TRASH_BLOCK] * (mbl - len(self._owned[s]))
            for s in range(self.slots))

    def _flush_tables(self) -> None:
        """Push the host block tables to the device before any step that
        follows an alloc or free: a freed lane's stale row would route its
        idle-lane writes into blocks now owned by another lane."""
        if self._table_dirty:
            self._table_dev.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    # ------------- prefill -------------
    def _schedule_prefill(self, done: List[Request]) -> None:
        free = [s for s in range(self.slots) if s not in self.active]
        batch: List[Tuple[int, Request]] = []
        for slot in free:
            if not self.queue:
                break
            req = self.queue[0]
            if self.kv_layout == "paged":
                need = -(-len(req.prompt) // self.kv_block_size)
                if not self._alloc_blocks(slot, need):
                    if not batch and not self.active \
                            and need > self.kv_blocks - 1:
                        # the whole pool cannot hold this prompt
                        self.queue.popleft()
                        self._finish(None, req, "cache_full", done)
                        continue
                    break  # wait for blocks to come back
            self.queue.popleft()
            batch.append((slot, req))
        if batch:
            self._prefill_batch(batch, done)

    def _prefill_batch(self, batch: List[Tuple[int, Request]],
                       done: List[Request]) -> None:
        """One batched prefill over the admitted requests, padded to pow2
        (rows, length) buckets, into a fresh contiguous row cache that is
        then scattered into the lanes."""
        t_start = time.monotonic()
        lens = [len(r.prompt) for _, r in batch]
        Sb = min(_pow2_bucket(max(lens), self.prefill_bucket_min),
                 self.max_len)
        Bp = _pow2_bucket(len(batch))
        tokens = np.zeros((Bp, Sb), np.int32)
        last_idx = np.zeros((Bp,), np.int64)
        slot_ids = np.zeros((Bp,), np.int64)
        valid = np.zeros((Bp,), bool)
        for i, (slot, req) in enumerate(batch):
            tokens[i, :lens[i]] = req.prompt
            last_idx[i] = lens[i] - 1
            slot_ids[i] = slot
            valid[i] = True
        row_cache = self.model.init_cache(Bp, Sb)
        logits, row_cache, _ = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device)},
            row_cache, torch.from_numpy(last_idx).to(self.device))
        toks = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        self._scatter_rows(row_cache, slot_ids, valid, Sb)
        now = time.monotonic()
        for i, (slot, req) in enumerate(batch):
            req.t_queue = t_start - req.t_submit
            self._activate(slot, req, int(toks[i]), lens[i], now, done)

    def _scatter_rows(self, row_cache, slot_ids: np.ndarray,
                      valid: np.ndarray, Sb: int) -> None:
        """Scatter a fresh (Bp, Sb) row cache into the lanes: paged layers
        through the lanes' block tables (padding rows and blocks past a
        row's owned ones land in the trash block), contiguous layers row
        by row for the valid rows."""
        if self.kv_layout == "paged":
            bs = self.kv_block_size
            nb = -(-Sb // bs)
            bt = np.full((len(slot_ids), nb), TRASH_BLOCK, np.int64)
            for i, slot in enumerate(slot_ids):
                if valid[i]:
                    owned = self._owned[int(slot)]
                    take = min(len(owned), nb)
                    bt[i, :take] = owned[:take]
            blk = torch.from_numpy(bt).to(self.device)
            for lane_c, row_c in zip(self.cache, row_cache):
                paged_scatter_rows(lane_c["kpool"], row_c["k"], blk)
                paged_scatter_rows(lane_c["vpool"], row_c["v"], blk)
            self._flush_tables()
            return
        rows = torch.from_numpy(np.flatnonzero(valid)).to(self.device)
        lanes = torch.from_numpy(slot_ids[valid]).to(self.device)
        for lane_c, row_c in zip(self.cache, row_cache):
            for key in ("k", "v"):
                lane_c[key][lanes, :Sb] = row_c[key][rows]

    def _activate(self, slot: int, req: Request, first_tok: int, P: int,
                  now: float, done: List[Request]) -> None:
        req.output.append(first_tok)
        req.t_first = now
        self.last_tok[slot] = first_tok
        self.pos[slot] = P
        self.active[slot] = req
        reason = self._finish_reason(req, first_tok, P)
        if reason:
            self._finish(slot, req, reason, done)

    # ------------- decode -------------
    def _finish_reason(self, req: Request, tok: int, pos: int
                       ) -> Optional[str]:
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.output) >= req.max_new_tokens:
            return "length"
        if pos >= self.max_len - 1:
            return "max_len"
        return None

    def _finish(self, slot: Optional[int], req: Request, reason: str,
                done: List[Request]) -> None:
        req.finish_reason = reason
        req.t_done = time.monotonic()
        self.counters[reason] += 1
        done.append(req)
        if slot is not None:
            self.active.pop(slot, None)
            self.pos[slot] = 0
            self.last_tok[slot] = 0
            if self.kv_layout == "paged":
                self._free_slot_blocks(slot)

    def _ensure_decode_blocks(self, done: List[Request]) -> None:
        """A lane about to write position p needs block p // bs; with the
        pool dry the lane finishes with cache_full."""
        bs = self.kv_block_size
        for slot, req in sorted(self.active.items()):
            if int(self.pos[slot]) // bs >= len(self._owned[slot]) \
                    and not self._alloc_blocks(slot, 1):
                self._finish(slot, req, "cache_full", done)

    def _decode_step(self, done: List[Request]) -> None:
        if self.kv_layout == "paged":
            self._ensure_decode_blocks(done)
            self._flush_tables()
            if not self.active:
                return
        toks = torch.from_numpy(self.last_tok).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = self.model.decode_step(self.params, toks, pos,
                                                    self.cache)
        nxt = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        for slot, req in list(self.active.items()):
            t = int(nxt[slot])
            req.output.append(t)
            self.pos[slot] += 1
            self.last_tok[slot] = t
            reason = self._finish_reason(req, t, int(self.pos[slot]))
            if reason:
                self._finish(slot, req, reason, done)

    # ------------- metrics -------------
    @staticmethod
    def latency_report(done: List[Request]) -> ServeReport:
        """Wall-clock latency summary: mean/p50/p99 TTFT and end-to-end,
        queue wait, and aggregate tokens/s over the span of the batch."""
        if not done:
            return ServeReport()

        def pcts(vals):
            if not vals:
                nan = float("nan")
                return nan, nan, nan
            return (float(np.mean(vals)), float(np.percentile(vals, 50)),
                    float(np.percentile(vals, 99)))

        ttft = [r.t_first - r.t_submit for r in done if r.t_first]
        e2e = [r.t_done - r.t_submit for r in done if r.t_done]
        ttft_mean, ttft_p50, ttft_p99 = pcts(ttft)
        e2e_mean, e2e_p50, e2e_p99 = pcts(e2e)
        new_tokens = sum(len(r.output) for r in done)
        t0 = min(r.t_submit for r in done)
        t1 = max((r.t_done for r in done if r.t_done), default=t0)
        return ServeReport({
            "n": len(done),
            "finish_reasons": ServeReport.finish_reasons(done),
            "ttft_mean_s": ttft_mean,
            "ttft_p50_s": ttft_p50,
            "ttft_p99_s": ttft_p99,
            "e2e_mean_s": e2e_mean,
            "e2e_p50_s": e2e_p50,
            "e2e_p99_s": e2e_p99,
            "queue_wait_mean_s": float(np.mean([r.t_queue for r in done])),
            "new_tokens": new_tokens,
            "tokens_per_s": new_tokens / max(t1 - t0, 1e-9),
        })

    def _kv_bytes(self, caches) -> int:
        return sum(t.numel() * t.element_size() for c in caches
                   for key, t in c.items() if key in ("k", "v", "kpool",
                                                       "vpool"))

    def kv_report(self) -> ServeReport:
        """KV residency: bytes resident for attention K/V under the current
        layout against what the contiguous `slots * max_len` layout would
        hold (shape arithmetic, so it is exact and deterministic)."""
        cfg = self.model.cfg
        per_token = 2 * cfg.n_kv_heads * cfg.head_dim * torch.finfo(
            cfg.cdtype).bits // 8
        contiguous = cfg.n_layers * self.slots * self.max_len * per_token
        return ServeReport({
            "kv_layout": self.kv_layout,
            "kv_bytes_resident": self._kv_bytes(self.cache),
            "kv_bytes_contiguous": contiguous,
            "kv_block_size": (self.kv_block_size
                              if self.kv_layout == "paged" else 0),
            "kv_blocks_usable": max(self.kv_blocks - 1, 0),
            "kv_blocks_free": self.free_blocks,
            "kv_blocks_held": 0,
            "kv_blocks_peak_used": self.blocks_peak_used,
            "integrity_ok": self._integrity_ok(),
        })
