"""Continuous-batching serving engine with a paged KV cache (port of
`repro/serving/engine.py`).

A fixed pool of `slots` decode lanes shares one decode step; a request
queue feeds empty lanes.

  * Prefill is GEMM-shaped: waiting requests are batched together, their
    prompts right-padded to a shared pow2 length bucket and the batch row
    count padded to a pow2 bucket. Per-lane `last_index` picks each
    prompt's real final position out of the padded rows. A model with a
    recurrent or SSM layer (its state advances over a pad tail) or a
    sliding window (a pad tail longer than the window would wrap its
    ring) prefills one request at a time at its exact length instead. A
    `prefill_chunk` knob splits long prompts of attention-only models into
    fixed-size chunks interleaved with decode steps, so one long prompt
    never stalls the running decode lanes.
  * Decode stays GEMV-shaped: one token per lane per step, greedy.

KV memory defaults to the paged layout (`kv_layout="paged"`): each layer
holds a block pool plus per-lane block tables, so residency scales with
live tokens instead of `slots * max_len`, and finished lanes return their
blocks to the free list at once. Block 0 is the shared trash block.
Sliding-window layers keep their contiguous rings and recurrent layers
their per-lane states under either layout; the allocator keeps its
accounting when no layer is paged. The
contiguous layout (`kv_layout="contiguous"`) is kept as the reference the
paged one is held against token for token.

Finished lanes (EOS, max_new_tokens, max_len) are recycled immediately.

**Fault tolerance.** Resource pressure has more answers than
`finish_reason="cache_full"`:

  * **Deadlines** - `Request.deadline_steps` is a scheduler-step budget
    from submission; expired requests finish with
    `finish_reason="deadline"` at the schedule and decode boundaries
    (never mid-token), keeping the tokens they already produced.
  * **Backpressure** - `max_queue` bounds the admission queue; an
    overflowing submit is shed at once with `finish_reason="rejected"`
    (sheds drain into the `run`/`step` done list).
  * **Preemption with recompute** - decode-time block exhaustion evicts
    the lowest-priority active lane (lowest `Request.priority`, then
    youngest activation): its blocks return to the free list and it
    requeues at the head to re-prefill from prompt + generated tokens.
    The paged view's slot == position invariant makes the recomputed
    stream token-identical to an uninterrupted run. `preempt_limit`
    bounds ping-pong; `preempt=False` keeps the terminal `cache_full`.
  * **Tier degradation** - `degrade_ladder` (serving/degrade.py) walks
    rejected or preempted requests down a ladder of registered DotEngine
    modes under queue or KV pressure; `Request.served_tier` records the
    mode actually served.
  * **Integrity and numerics guards** - the block allocator validates
    every id it hands out and detects double frees; `integrity_audit`
    also audits the lane tables each step and repairs a corrupted lane by
    preempt-and-recompute; `numerics_check` finishes a lane whose logits
    go NaN/Inf with `finish_reason="numerics"`. Both are off by default,
    and then the logits never leave the device except as argmax tokens.
    `serving/faults.py` injects faults through `reserve_blocks`,
    `corrupt_table_entry`, `logits_tap` and `prefill_fault`.

Entry points are plain calls, not compiled programs: `prefill_traces` and
`decode_traces` count the distinct input shapes each tier's entry points
have been called with, which is what the reference's jit trace counters
count.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter, deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.numerics import EngineSpec, resolve_engine
from repro_torch.models.layers import TRASH_BLOCK, paged_scatter_rows
from repro_torch.models.model import Model, resolve_device
from .degrade import DegradeLadder
from .faults import TransientPrefillError
from .report import ServeReport

__all__ = ["Request", "ServeEngine"]


# Block kinds whose prefill is safe to right-pad: causal attention masks
# padded positions out, and later decode steps overwrite their cache slots
# position for position. Recurrent and SSM state advances on every token,
# so a padded tail would corrupt it: those families prefill each request
# at its exact length.
_PAD_SAFE_KINDS = frozenset({"attn", "cross", "xdec"})


def _pow2_bucket(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, math.ceil(math.log2(max(1, n)))))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # Per-request quality tier: a key of the engine's `quality_tiers`
    # mapping (None = the deployment's base numerics). Decode batches are
    # tier-homogeneous, so a request asking for a truncated olm{n}t{p}
    # tier decodes every token under that mode.
    quality_tier: Optional[str] = None
    # Scheduler-step budget from submission (None = no deadline); see the
    # module docstring.
    deadline_steps: Optional[int] = None
    # Preemption victim ordering: lower priority is evicted first (ties:
    # youngest activation, then highest rid). It does not reorder the
    # FIFO admission queue.
    priority: int = 0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_queue: float = 0.0                # seconds waited before prefill
    # eos | length | max_len | cache_full | deadline | rejected |
    # numerics | failed
    finish_reason: Optional[str] = None
    # scheduler-step stamps: the deterministic virtual-time analogues of
    # the wall-clock fields, which the replay harness reports
    s_submit: Optional[int] = None
    s_first: Optional[int] = None
    s_done: Optional[int] = None
    # robustness bookkeeping (filled by the engine):
    n_preempts: int = 0                 # times evicted + requeued
    n_retries: int = 0                  # transient prefill retries
    served_tier: Optional[str] = None   # DotEngine mode actually served
    degrade_rung: int = 0               # ladder rung actually served
    # engine-internal: effective tier after degradation (a key of the
    # engine's quality_tiers; None = the request's own tier)
    eff_tier: Optional[str] = None


class _EntryPoints:
    """One tier mode's prefill, chunked-prefill and decode calls, counting
    the distinct input shapes each has seen into `traces` (shared by the
    engine's tiers: its prefill_traces / decode_traces, the reference's
    jit trace counts). It holds no reference to the engine, so an engine
    is freed, params and caches with it, as soon as its last name goes."""

    def __init__(self, model: Model, traces: Counter):
        self.model, self.traces = model, traces
        self._seen: set = set()

    def _note(self, key, counter: str) -> None:
        if key not in self._seen:
            self._seen.add(key)
            self.traces[counter] += 1

    def prefill(self, params, tokens, cache, last_index):
        self._note(("prefill", tuple(tokens.shape)), "prefill")
        return self.model.prefill(params, {"tokens": tokens}, cache,
                                  last_index)

    def prefill_chunk(self, params, tokens, cache, start, last_index):
        self._note(("chunk", tuple(tokens.shape), cache[0]["k"].shape[1]),
                   "prefill")
        return self.model.prefill_chunk(params, {"tokens": tokens}, cache,
                                        start, last_index=last_index)

    def decode(self, params, tokens, pos, cache, memory):
        self._note(("decode", tuple(tokens.shape)), "decode")
        return self.model.decode_step(params, tokens, pos, cache, memory)


class ServeEngine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 512, dot_mode: Optional[str] = None,
                 dot_tiling: Union[str, Dict[str, object], None] = None,
                 kv_layout: str = "paged", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_bucket_min: int = 8,
                 quality_tiers: Optional[Dict[str, str]] = None,
                 max_queue: Optional[int] = None,
                 preempt: bool = True,
                 preempt_limit: int = 8,
                 numerics_check: bool = False,
                 integrity_audit: bool = False,
                 prefill_retries: int = 3,
                 prefill_backoff: int = 1,
                 degrade_ladder: Optional[Sequence[str]] = None,
                 degrade_free_frac: float = 0.25,
                 degrade_queue_headroom: Optional[int] = None,
                 engine: Optional[EngineSpec] = None,
                 mesh=None, device=None):
        """`device` names where the engine serves (CUDA unless given) and
        must be the model's device. `engine=` (an EngineSpec) is the
        declarative form of the legacy dot_mode / dot_tiling /
        quality_tiers / degrade_ladder keywords, resolved against the
        model's engine; passing both raises. Either way the numerics
        resolve through core.numerics.resolve_engine. `mesh=` (a
        DeviceMesh) with `shard` set in the spec routes the olm GEMMs
        through the mesh-sharded front-end, tiers included
        (kernels/online_dot/matmul_sharded): every rank runs the whole
        engine and gets every output."""
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} but the model lives on "
                             f"{model.device}")
        if engine is not None:
            if (dot_mode is not None or dot_tiling is not None
                    or quality_tiers is not None
                    or degrade_ladder is not None):
                raise ValueError(
                    "pass either engine= (EngineSpec) or the legacy "
                    "dot_mode/dot_tiling/quality_tiers/degrade_ladder "
                    "kwargs, not both")
            eng = resolve_engine(engine, base=model.eng, mesh=mesh)
            if eng != model.eng:
                model = Model(model.cfg, eng, device=dev)
            if engine.quality_tiers is not None:
                quality_tiers = dict(engine.quality_tiers)
            if engine.degrade_ladder is not None:
                degrade_ladder = tuple(engine.degrade_ladder)
        else:
            if isinstance(dot_tiling, str):
                if dot_tiling != "auto":
                    raise ValueError(
                        f"unknown dot_tiling {dot_tiling!r}: the only "
                        "string form is 'auto' (or pass a dict of knobs)")
                dot_tiling = {"tiling": "auto"}
            override = dict(dot_tiling or {})
            if bad := set(override) - {"k_tile", "block_m", "block_n",
                                       "tiling"}:
                raise ValueError(f"unknown dot_tiling knobs: {sorted(bad)}")
            if override.get("tiling") == "auto":
                # asking for the autotuner clears the block pins it would
                # choose (a pinned k_tile is numerics and survives)
                for knob in ("block_m", "block_n"):
                    override.setdefault(knob, None)
            if dot_mode is not None and dot_mode != model.eng.mode:
                override["mode"] = dot_mode
            if override or mesh is not None:
                eng = resolve_engine(EngineSpec(**override), base=model.eng,
                                     mesh=mesh)
                if eng != model.eng:
                    model = Model(model.cfg, eng, device=dev)
        self.model = model
        self.params = params
        self.device = dev
        self.slots = slots
        self.max_len = max_len
        # quality_tiers maps tier name -> DotEngine mode: one set of
        # params served at several numerics levels. A tier is a Model
        # view with a replaced engine (the digit modes quantize at use);
        # tier None is the base deployment.
        self.quality_tiers = dict(quality_tiers or {})

        # Tier-degradation ladder: rungs 1.. are registered as internal
        # quality tiers keyed by their mode name, so a degraded request
        # rides the tier-homogeneous scheduler unchanged.
        self.degrade: Optional[DegradeLadder] = None
        if degrade_ladder is not None:
            headroom = (max(1, slots) if degrade_queue_headroom is None
                        else degrade_queue_headroom)
            self.degrade = DegradeLadder.build(
                degrade_ladder, base_mode=model.eng.mode,
                free_frac=degrade_free_frac, queue_headroom=headroom)
            for m in self.degrade.ladder[1:]:
                if self.quality_tiers.setdefault(m, m) != m:
                    raise ValueError(
                        f"degrade_ladder rung {m!r} collides with a "
                        f"quality tier of the same name mapped to mode "
                        f"{self.quality_tiers[m]!r}")
        self._active_tier: Optional[str] = None
        self._tier_models: Dict[Optional[str], Model] = {}
        self._tier_fns: Dict[Optional[str], _EntryPoints] = {}

        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        if preempt_limit < 1:
            raise ValueError("preempt_limit must be >= 1")
        if prefill_retries < 0 or prefill_backoff < 0:
            raise ValueError("prefill_retries/prefill_backoff must be >= 0")
        self.max_queue = max_queue
        self.preempt = preempt
        self.preempt_limit = preempt_limit
        self.numerics_check = numerics_check
        self.integrity_audit = integrity_audit
        self.prefill_retries = prefill_retries
        self.prefill_backoff = prefill_backoff
        # Robustness event counters (recoveries; terminal finish_reason
        # counts land here too, keyed by the reason).
        self.counters: Counter = Counter()
        # Requests shed at submit; drained into the done list at the next
        # step()/run() boundary.
        self.shed: Deque[Request] = deque()
        # Fault-injection surfaces (serving/faults.py): logits_tap(lg,
        # phase, step) -> lg runs on the host copy of the raw logits (a
        # float32 numpy array); prefill_fault(step, reqs) may raise
        # TransientPrefillError to exercise the retry/backoff path.
        self.logits_tap: Optional[Callable] = None
        self.prefill_fault: Optional[Callable] = None
        self._prefill_backoff_until = 0

        cfg = model.cfg
        # pow2 prompt bucketing needs right-padding to be harmless: see
        # _PAD_SAFE_KINDS; and a pad tail longer than the window would
        # wrap a sliding-window ring and overwrite positions still in the
        # window. Such models prefill each request at its exact length.
        self._bucketed = (set(cfg.layer_kinds) <= _PAD_SAFE_KINDS
                          and cfg.sliding_window is None)
        self.prefill_bucket_min = prefill_bucket_min

        if prefill_chunk is not None:
            if not set(cfg.layer_kinds) <= _PAD_SAFE_KINDS:
                raise ValueError(
                    "prefill_chunk requires an attention-only block "
                    "pattern (recurrent/SSM state can't be chunk-padded)")
            if cfg.sliding_window is not None:
                raise ValueError(
                    "prefill_chunk is not supported with sliding_window "
                    "(ring caches can't take chunked writes)")
            if prefill_chunk < 1 or max_len % prefill_chunk != 0:
                raise ValueError(
                    f"prefill_chunk must divide max_len ({max_len}); "
                    f"got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk

        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.kv_layout = kv_layout
        self.kv_block_size = kv_block_size
        self._table: Optional[np.ndarray] = None
        self._table_dirty = False
        # Integrity shadow state: every usable block is in exactly one of
        # {free, owned by one lane, held}. _owner/_free_set let alloc and
        # free validate ids in O(1) and detect double frees; _held tracks
        # blocks reserved out of the pool (fault injection).
        self._owner: Dict[int, int] = {}
        self._free_set: set = set()
        self._held: set = set()
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
            # the block table shared by the paged layers (None when every
            # layer keeps a ring)
            self._table_dev = next((c["table"] for c in self.cache
                                    if "table" in c), None)
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
        self.step_count = 0
        # the reference's stub: no frontend memory is served (the serve
        # CLI refuses the encdec and vlm families)
        self.memory = None
        self.pending_chunk: Optional[Dict[str, Any]] = None
        self._traces: Counter = Counter()

        # Tiers naming the same mode share one Model view and its entry
        # points (and so their shape counts); every view shares params.
        by_mode: Dict[str, Tuple[Model, _EntryPoints]] = {}
        for tier, mode in ([(None, model.eng.mode)]
                           + sorted(self.quality_tiers.items())):
            if mode not in by_mode:
                m = model if mode == model.eng.mode else Model(
                    model.cfg, dataclasses.replace(model.eng, mode=mode),
                    device=dev)
                by_mode[mode] = (m, _EntryPoints(m, self._traces))
            self._tier_models[tier], self._tier_fns[tier] = by_mode[mode]

    @property
    def prefill_traces(self) -> int:
        """Distinct prefill and chunk input shapes run, over all tiers."""
        return self._traces["prefill"]

    @property
    def decode_traces(self) -> int:
        """Distinct decode input shapes run, over all tiers."""
        return self._traces["decode"]

    # The entry points of whichever tier currently owns the lanes; tier
    # switches happen only in _schedule_prefill while no lane is active,
    # so every decode batch is tier-homogeneous.
    @property
    def _fns(self) -> _EntryPoints:
        return self._tier_fns[self._active_tier]

    # ------------- client API -------------
    def submit(self, req: Request) -> bool:
        P = len(req.prompt)
        if P < 1 or P > self.max_len - 1:
            raise ValueError(
                f"prompt length {P} outside [1, max_len-1={self.max_len - 1}]")
        if req.quality_tier is not None \
                and req.quality_tier not in self.quality_tiers:
            raise ValueError(
                f"unknown quality_tier {req.quality_tier!r}; configured "
                f"tiers: {sorted(self.quality_tiers) or 'none'}")
        if req.deadline_steps is not None and req.deadline_steps < 1:
            raise ValueError(
                f"deadline_steps must be >= 1, got {req.deadline_steps}")
        req.t_submit = time.monotonic()
        req.s_submit = self.step_count
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # Backpressure: past the hard bound, re-admit one ladder rung
            # down while headroom lasts, else shed as "rejected".
            if (self.degrade is not None
                    and len(self.queue)
                    < self.max_queue + self.degrade.queue_headroom
                    and self._downshift(req)):
                self.queue.append(req)
                return True
            self._finish(None, req, "rejected", self.shed)
            return False
        self.queue.append(req)
        return True

    def run(self, *, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        steps = 0
        while (self.queue or self.active or self.pending_chunk) \
                and steps < max_steps:
            self.step(done)
            steps += 1
        self._drain_shed(done)
        return done

    def step(self, done: List[Request]) -> None:
        """One scheduler iteration: advance or admit prefill work, then
        one decode step for every active lane."""
        self._drain_shed(done)
        if self.integrity_audit and self.kv_layout == "paged":
            self._audit_tables(done)
        self._schedule_prefill(done)
        if self.active:
            self._decode_step(done)
        self.step_count += 1

    def _drain_shed(self, done: List[Request]) -> None:
        while self.shed:
            done.append(self.shed.popleft())

    # ------------- block allocator (paged layout) -------------
    @property
    def free_blocks(self) -> int:
        return len(self._free) if self.kv_layout == "paged" else 0

    def owned_blocks(self, slot: int) -> List[int]:
        return list(self._owned[slot]) if self.kv_layout == "paged" else []

    def _note_usage(self) -> None:
        used = (self.kv_blocks - 1) - len(self._free)
        self.blocks_peak_used = max(self.blocks_peak_used, used)

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
        self._note_usage()
        return True

    def _free_slot_blocks(self, slot: int) -> None:
        owned = self._owned[slot]
        if not owned:
            return
        for bid in owned:
            if bid in self._free_set or self._owner.get(bid) != slot:
                why = ("already in the free list" if bid in self._free_set
                       else f"owned by lane {self._owner.get(bid)!r}")
                raise RuntimeError(
                    f"double-free: lane {slot} freeing block {bid} which "
                    f"is {why} - allocator state corrupted")
            del self._owner[bid]
        self._free.extend(reversed(owned))
        self._free_set.update(owned)
        self._owned[slot] = []
        self._table[slot, :] = TRASH_BLOCK
        self._table_dirty = True

    def reserve_blocks(self, n: int) -> List[int]:
        """Take up to n blocks out of the free pool (fault injection);
        they count as used until release_blocks returns them."""
        if self.kv_layout != "paged":
            raise ValueError("reserve_blocks requires kv_layout='paged'")
        ids: List[int] = []
        for _ in range(min(n, len(self._free))):
            bid = self._free.pop()
            self._free_set.discard(bid)
            self._held.add(bid)
            ids.append(bid)
        self._note_usage()
        return ids

    def release_blocks(self, ids: Sequence[int]) -> None:
        """Return blocks taken by reserve_blocks to the free pool."""
        for bid in ids:
            if bid not in self._held:
                raise RuntimeError(
                    f"release_blocks: block {bid} was not reserved")
            self._held.discard(bid)
            self._free.append(bid)
            self._free_set.add(bid)

    def corrupt_table_entry(self, slot: int, j: int, bid: int) -> None:
        """FAULT-INJECTION surface: overwrite one host block-table entry
        (and flush it to the device) past the allocator's guards. The
        integrity audit (integrity_audit=True) detects and repairs it."""
        if self.kv_layout != "paged":
            raise ValueError("corrupt_table_entry requires kv_layout='paged'")
        self._table[slot, j] = bid
        self._table_dirty = True
        self._flush_tables()

    def _audit_tables(self, done: List[Request]) -> None:
        """Step-boundary audit: a lane whose table row disagrees with the
        allocator's owned list is repaired - an active lane is preempted
        and recomputes from its tokens, an idle lane's row is rebuilt.
        Faults inject at the step boundary and the audit runs at step
        start, so a corrupted entry is never used."""
        mbl = self.blocks_per_lane
        for slot in range(self.slots):
            owned = self._owned[slot]
            want = owned + [TRASH_BLOCK] * (mbl - len(owned))
            if list(self._table[slot]) == want:
                continue
            self.counters["table_repairs"] += 1
            req = self.active.get(slot)
            if req is not None:
                self._preempt(slot, req, done)
            else:
                self._table[slot, :] = TRASH_BLOCK
                self._table[slot, :len(owned)] = owned
                self._table_dirty = True

    def _integrity_ok(self) -> bool:
        """Usable blocks partition into free / owned / held with no
        duplicates, the shadow maps agree, and every lane table row is its
        owned list then trash padding."""
        if self.kv_layout != "paged":
            return True
        free, held = set(self._free), set(self._held)
        owned_all = [b for blks in self._owned.values() for b in blks]
        owned = set(owned_all)
        if len(free) != len(self._free) or len(owned) != len(owned_all):
            return False
        if (free & owned) or (free & held) or (owned & held):
            return False
        if free | owned | held != set(range(1, self.kv_blocks)):
            return False
        if free != self._free_set:
            return False
        if any(self._owner.get(b) != s
               for s, blks in self._owned.items() for b in blks) \
                or len(self._owner) != len(owned):
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
            if self._table_dev is not None:
                self._table_dev.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    # ------------- robustness helpers -------------
    def _req_tokens(self, req: Request) -> np.ndarray:
        """Tokens to prefill: the prompt, plus - after a preemption -
        everything the request already generated, so the recomputed lane
        resumes at its pre-eviction position."""
        if not req.output:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.output, np.int32)])

    def _tier_of(self, req: Request) -> Optional[str]:
        """Effective scheduling tier: the degraded tier if the ladder
        downshifted this request, else its own quality_tier."""
        return req.eff_tier if req.eff_tier is not None else req.quality_tier

    def _tier_mode(self, tier: Optional[str]) -> str:
        return self._tier_models[tier].eng.mode

    def _downshift(self, req: Request) -> bool:
        """Move a request one ladder rung down. False at the bottom."""
        if self.degrade is None:
            return False
        rung = self.degrade.rung_of(self._tier_mode(self._tier_of(req)))
        nxt = self.degrade.next_mode(rung)
        if nxt is None:
            return False
        req.eff_tier = nxt
        req.degrade_rung = rung + 1
        self.counters["degraded"] += 1
        return True

    def _expired(self, req: Request) -> bool:
        return (req.deadline_steps is not None
                and req.s_submit is not None
                and self.step_count - req.s_submit >= req.deadline_steps)

    def _purge_queue_deadlines(self, done: List[Request]) -> None:
        if not any(r.deadline_steps is not None for r in self.queue):
            return
        kept: Deque[Request] = deque()
        for req in self.queue:
            if self._expired(req):
                self._finish(None, req, "deadline", done)
            else:
                kept.append(req)
        self.queue = kept

    def _pick_victim(self) -> Tuple[int, Request]:
        """Preemption victim among active lanes: lowest priority first,
        then youngest activation, then highest rid."""
        return min(self.active.items(),
                   key=lambda kv: (kv[1].priority,
                                   -(kv[1].s_first or 0), -kv[1].rid))

    def _preempt(self, slot: int, req: Request, done: List[Request]) -> None:
        """Evict an active lane: free its blocks and requeue it at the
        head to re-prefill from its tokens. Past preempt_limit the
        eviction is terminal (cache_full). Under KV pressure a requeued
        request downshifts one ladder rung."""
        self.active.pop(slot, None)
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        if self.kv_layout == "paged":
            self._free_slot_blocks(slot)
        if req.n_preempts >= self.preempt_limit:
            self._finish(None, req, "cache_full", done)
            return
        req.n_preempts += 1
        self.counters["preempted"] += 1
        if self.degrade is not None and self.degrade.kv_pressure(
                self.free_blocks, self.kv_blocks - 1):
            self._downshift(req)
        self.queue.appendleft(req)

    # ------------- prefill scheduling -------------
    def _schedule_prefill(self, done: List[Request]) -> None:
        self._purge_queue_deadlines(done)
        if self.pending_chunk is not None:
            self._advance_chunk(done)
            return
        if self.step_count < self._prefill_backoff_until:
            return                          # backing off after a failure
        free = [s for s in range(self.slots) if s not in self.active]
        if not free or not self.queue:
            return
        head = self.queue[0]
        # Tier-homogeneous batching: a head asking for another tier waits
        # for the running lanes to drain (strict FIFO); an idle engine
        # adopts the head's tier for the next wave.
        if self.active and self._tier_of(head) != self._active_tier:
            return
        if not self.active:
            self._active_tier = self._tier_of(head)
        if self.prefill_chunk \
                and len(self._req_tokens(head)) > self.prefill_chunk:
            self._start_chunk(free[0], done)
            return
        batch: List[Tuple[int, Request]] = []
        for slot in free:
            if not self.queue:
                break
            req = self.queue[0]
            if self._tier_of(req) != self._active_tier:
                break                       # tier boundary: next wave
            toks = self._req_tokens(req)
            if self.prefill_chunk and len(toks) > self.prefill_chunk:
                break                       # chunked on a later step, alone
            if self.kv_layout == "paged":
                need = -(-len(toks) // self.kv_block_size)
                if not self._alloc_blocks(slot, need):
                    if not batch and not self.active \
                            and need > self.kv_blocks - 1:
                        # the whole pool cannot hold this prompt even
                        # idle (a transient shortfall waits instead)
                        self.queue.popleft()
                        self._finish(None, req, "cache_full", done)
                        continue
                    break                   # wait for blocks to come back
            self.queue.popleft()
            batch.append((slot, req))
            if not self._bucketed:
                break                       # exact length: one a call
        if batch:
            self._prefill_batch(batch, done)

    def _host_logits(self, logits: torch.Tensor, phase: str) -> np.ndarray:
        """The step's logits on the host, through the fault tap."""
        lg = logits.cpu().numpy()
        if self.logits_tap is not None:
            lg = self.logits_tap(lg, phase, self.step_count)
        return lg

    def _prefill_batch(self, batch: List[Tuple[int, Request]],
                       done: List[Request]) -> None:
        """One batched prefill over the admitted requests, padded to pow2
        (rows, length) buckets (unpadded for a windowed model), into a
        fresh contiguous row cache that is then scattered into the
        lanes."""
        t_start = time.monotonic()
        if self.prefill_fault is not None:
            try:
                self.prefill_fault(self.step_count, [r for _, r in batch])
            except TransientPrefillError:
                self._prefill_retry(batch, done)
                return
        seqs = [self._req_tokens(r) for _, r in batch]
        lens = [len(s) for s in seqs]
        if self._bucketed:
            Sb = min(_pow2_bucket(max(lens), self.prefill_bucket_min),
                     self.max_len)
            Bp = _pow2_bucket(len(batch))
        else:
            Sb, Bp = max(lens), len(batch)
        tokens = np.zeros((Bp, Sb), np.int32)
        last_idx = np.zeros((Bp,), np.int64)
        slot_ids = np.zeros((Bp,), np.int64)
        valid = np.zeros((Bp,), bool)
        for i, (slot, req) in enumerate(batch):
            tokens[i, :lens[i]] = seqs[i]
            last_idx[i] = lens[i] - 1
            slot_ids[i] = slot
            valid[i] = True
        row_cache = self.model.init_cache(Bp, Sb)
        logits, row_cache, _ = self._fns.prefill(
            self.params, torch.from_numpy(tokens).to(self.device), row_cache,
            torch.from_numpy(last_idx).to(self.device))
        if self.logits_tap is not None or self.numerics_check:
            lg = self._host_logits(logits, "prefill")
            if self.numerics_check:
                finite = np.isfinite(lg).all(axis=-1)
                for i, (slot, req) in enumerate(batch):
                    if not finite[i]:
                        # bad row: never scattered, never activated
                        valid[i] = False
                        if self.kv_layout == "paged":
                            self._free_slot_blocks(slot)
                        self._finish(None, req, "numerics", done)
            with np.errstate(invalid="ignore"):
                toks = lg.argmax(axis=-1).astype(np.int32)
        else:
            toks = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        self._scatter_rows(row_cache, slot_ids, valid, Sb)
        now = time.monotonic()
        for i, (slot, req) in enumerate(batch):
            if not valid[i]:
                continue                    # finished above (numerics)
            req.t_queue = t_start - req.t_submit
            self._activate(slot, req, int(toks[i]), lens[i], now, done)

    def _prefill_retry(self, batch: List[Tuple[int, Request]],
                       done: List[Request]) -> None:
        """Transient prefill failure: release the batch's blocks, return
        it to the queue head in arrival order, and back off exponentially
        (prefill_backoff * 2**(attempt-1) steps). A request past
        prefill_retries finishes with reason "failed"."""
        self.counters["prefill_retries"] += 1
        for slot, req in reversed(batch):
            if self.kv_layout == "paged":
                self._free_slot_blocks(slot)
            req.n_retries += 1
            if req.n_retries > self.prefill_retries:
                self._finish(None, req, "failed", done)
            else:
                self.queue.appendleft(req)
        attempt = max(r.n_retries for _, r in batch)
        self._prefill_backoff_until = (
            self.step_count + self.prefill_backoff * (1 << (attempt - 1)))

    def _scatter_rows(self, row_cache, slot_ids: np.ndarray,
                      valid: np.ndarray, Sb: int) -> None:
        """Scatter a fresh (Bp, Sb) row cache into the lanes, layer by
        layer: paged layers through the lanes' block tables (padding rows,
        invalid rows and blocks past a row's owned ones land in the trash
        block); contiguous layers, sliding-window rings and every leaf of
        a recurrent state (h, conv) row by row for the valid rows."""
        blk = None
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
        rows = torch.from_numpy(np.flatnonzero(valid)).to(self.device)
        lanes = torch.from_numpy(slot_ids[valid]).to(self.device)
        for lane_c, row_c in zip(self.cache, row_cache):
            if "kpool" in lane_c:
                paged_scatter_rows(lane_c["kpool"], row_c["k"], blk)
                paged_scatter_rows(lane_c["vpool"], row_c["v"], blk)
            elif valid.any():
                for key, dst in lane_c.items():
                    src = row_c[key]
                    dst[lanes, :src.shape[1]] = src[rows].to(dst.dtype)
        if self.kv_layout == "paged":
            self._flush_tables()

    def _activate(self, slot: int, req: Request, first_tok: int, P: int,
                  now: float, done: List[Request]) -> None:
        req.output.append(first_tok)
        if req.t_first is None:
            # a preempted request's TTFT is its first activation
            req.t_first = now
            req.s_first = self.step_count
        req.served_tier = self._tier_mode(self._active_tier)
        self.last_tok[slot] = first_tok
        self.pos[slot] = P
        self.active[slot] = req
        reason = self._finish_reason(req, first_tok, P)
        if reason:
            self._finish(slot, req, reason, done)

    # ------------- chunked prefill -------------
    def _start_chunk(self, slot: int, done: List[Request]) -> None:
        req = self.queue[0]
        seq = self._req_tokens(req)
        P = len(seq)
        chunk = self.prefill_chunk
        nchunks = -(-P // chunk)
        total = nchunks * chunk             # <= max_len: chunk | max_len
        if self.kv_layout == "paged":
            need = -(-P // self.kv_block_size)
            if not self._alloc_blocks(slot, need):
                if not self.active and need > self.kv_blocks - 1:
                    self.queue.popleft()
                    self._finish(None, req, "cache_full", done)
                return
        self.queue.popleft()
        req.t_queue = time.monotonic() - req.t_submit
        self.pending_chunk = {
            "req": req, "slot": slot, "seq": seq,
            "next": 0, "nchunks": nchunks,
            "row_cache": self.model.init_cache(1, total),
        }

    def _abort_chunk(self) -> Dict[str, Any]:
        """Tear down the in-flight chunk state (deadline or transient
        failure), releasing the lane's blocks; nothing was activated or
        scattered yet."""
        c = self.pending_chunk
        self.pending_chunk = None
        if self.kv_layout == "paged":
            self._free_slot_blocks(c["slot"])
        return c

    def _advance_chunk(self, done: List[Request]) -> None:
        """Run one prompt chunk; decode lanes keep stepping in between."""
        c = self.pending_chunk
        req, slot, chunk = c["req"], c["slot"], self.prefill_chunk
        if self._expired(req):
            self._abort_chunk()
            self._finish(None, req, "deadline", done)
            return
        if self.prefill_fault is not None:
            try:
                self.prefill_fault(self.step_count, [req])
            except TransientPrefillError:
                # restart from chunk 0 after backoff (a fresh row cache)
                self._abort_chunk()
                self._prefill_retry([(slot, req)], done)
                return
        seq = c["seq"]
        P = len(seq)
        s0 = c["next"] * chunk
        piece = np.zeros((1, chunk), np.int32)
        real = seq[s0:s0 + chunk]
        piece[0, :len(real)] = real
        is_last = c["next"] == c["nchunks"] - 1
        li = np.asarray([(P - 1 - s0) if is_last else chunk - 1], np.int64)
        logits, c["row_cache"] = self._fns.prefill_chunk(
            self.params, torch.from_numpy(piece).to(self.device),
            c["row_cache"], s0, torch.from_numpy(li).to(self.device))
        c["next"] += 1
        if not is_last:
            return
        self.pending_chunk = None
        if self.logits_tap is not None or self.numerics_check:
            lg = self._host_logits(logits, "prefill")[0]
            if self.numerics_check and not np.isfinite(lg).all():
                if self.kv_layout == "paged":
                    self._free_slot_blocks(slot)
                self._finish(None, req, "numerics", done)
                return
            with np.errstate(invalid="ignore"):
                tok = int(lg.argmax())
        else:
            tok = int(logits[0].argmax())
        self._scatter_rows(c["row_cache"], np.asarray([slot], np.int64),
                           np.asarray([True]), c["nchunks"] * chunk)
        self._activate(slot, req, tok, P, time.monotonic(), done)

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
        req.s_done = self.step_count
        self.counters[reason] += 1
        done.append(req)
        if slot is not None:
            self.active.pop(slot, None)
            self.pos[slot] = 0
            self.last_tok[slot] = 0
            if self.kv_layout == "paged":
                self._free_slot_blocks(slot)

    def _ensure_decode_blocks(self, done: List[Request]) -> None:
        """A lane about to write position p needs block p // bs. With the
        pool dry, preempt the lowest-priority active lane (perhaps the
        needy one) instead; preempt=False finishes it with cache_full."""
        bs = self.kv_block_size
        for slot, req in sorted(self.active.items()):
            if slot not in self.active:
                continue                    # preempted earlier in this pass
            while int(self.pos[slot]) // bs >= len(self._owned[slot]):
                if self._alloc_blocks(slot, 1):
                    break
                if not self.preempt:
                    self._finish(slot, req, "cache_full", done)
                    break
                vslot, vreq = self._pick_victim()
                self._preempt(vslot, vreq, done)
                if vslot == slot:
                    break                   # the needy lane was evicted

    def _decode_step(self, done: List[Request]) -> None:
        for slot, req in list(self.active.items()):
            if self._expired(req):
                self._finish(slot, req, "deadline", done)
        if not self.active:
            return
        if self.kv_layout == "paged":
            self._ensure_decode_blocks(done)
            self._flush_tables()
            if not self.active:
                return
        toks = torch.from_numpy(self.last_tok).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = self._fns.decode(self.params, toks, pos,
                                              self.cache, self.memory)
        if self.logits_tap is not None or self.numerics_check:
            lg = self._host_logits(logits, "decode")
            if self.numerics_check:
                finite = np.isfinite(lg).all(axis=-1)
                for slot, req in list(self.active.items()):
                    if not finite[slot]:
                        # the poisoned token is never appended: the
                        # stream stays a clean prefix
                        self._finish(slot, req, "numerics", done)
            with np.errstate(invalid="ignore"):
                nxt = lg.argmax(axis=-1).astype(np.int32)
        else:
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
        layout against what the contiguous layout of `init_cache(slots,
        max_len)` would hold in its K/V leaves: its attention layers only
        (recurrent states are not K/V), a window layer's ring at its
        window. Shape arithmetic, so it is exact and deterministic."""
        cfg = self.model.cfg
        per_token = 2 * cfg.n_kv_heads * cfg.head_dim * torch.finfo(
            cfg.cdtype).bits // 8
        T = self.max_len            # a window layer's ring holds its window
        if cfg.sliding_window is not None:
            T = min(T, cfg.sliding_window)
        contiguous = (cfg.layer_kinds.count("attn") * self.slots * T
                      * per_token)
        return ServeReport({
            "kv_layout": self.kv_layout,
            "kv_bytes_resident": self._kv_bytes(self.cache),
            "kv_bytes_contiguous": contiguous,
            "kv_block_size": (self.kv_block_size
                              if self.kv_layout == "paged" else 0),
            "kv_blocks_usable": max(self.kv_blocks - 1, 0),
            "kv_blocks_free": self.free_blocks,
            "kv_blocks_held": len(self._held),
            "kv_blocks_peak_used": self.blocks_peak_used,
            "integrity_ok": self._integrity_ok(),
        })
