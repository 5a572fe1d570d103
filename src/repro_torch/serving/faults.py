"""Deterministic fault-injection harness for the serving engine (own copy
of `repro/serving/faults.py`).

A seeded :class:`FaultPlan` schedules four fault families against a
running :class:`~repro_torch.serving.engine.ServeEngine`:

  exhaust       allocator exhaustion — reserve (steal) free KV blocks
                through the engine's ``reserve_blocks`` API for a fixed
                number of scheduler steps, forcing decode-time block
                starvation (and therefore preemption-with-recompute).
  corrupt       block-table corruption — overwrite one live lane-table
                entry with an out-of-range or foreign (alias) block id
                via ``corrupt_table_entry``; the engine's integrity
                audit must detect and recover (preempt + recompute).
  nan           NaN/Inf activations — poison one active lane's decode
                logits at a chosen step through the engine's host-side
                ``logits_tap`` (the engine copies the step's logits to the
                host as a numpy array only while a tap or its numerics
                guard is set); the opt-in numerics guard must finish
                the request with ``finish_reason="numerics"`` instead
                of streaming garbage tokens.
  prefill_fail  transient prefill failure — the engine's
                ``prefill_fault`` gate raises
                :class:`TransientPrefillError` for the next N prefill
                attempts; the engine must retry with bounded backoff
                and eventually serve bit-identical tokens.

Every fire is deterministic: the plan is a pure function of
:class:`FaultConfig` (seeded numpy Generator — stable bit streams), and
the injector's per-step behavior depends only on the engine's own
deterministic scheduler state. An event whose precondition is not yet
met (no active lane, no free block to steal) **defers** to the next
step rather than being dropped, so the same plan resolves the same way
every run; ``stats`` records what actually fired so benches can assert
injected == resolved. Thread a plan through a replay with
``run_replay(engine, workload, faults=FaultInjector(plan))``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List

import numpy as np

__all__ = ["TransientPrefillError", "FaultConfig", "FaultPlan",
           "build_fault_plan", "FaultInjector"]


class TransientPrefillError(RuntimeError):
    """A prefill attempt failed transiently; the engine should retry
    with backoff (raised by fault injection or a real flaky backend)."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-plan shape. Steps are scheduler steps (the engine's
    virtual clock), so plans replay identically on any host."""
    seed: int = 0
    horizon_steps: int = 60        # events are scheduled in [2, horizon)
    n_exhaust: int = 1             # allocator-exhaustion events
    exhaust_blocks: int = 64       # blocks stolen per event (capped at free)
    exhaust_hold_steps: int = 8    # steps before stolen blocks return
    n_corrupt: int = 1             # block-table corruption events
    n_nan: int = 1                 # NaN-logits injections (decode step)
    n_prefill_fail: int = 1        # transient prefill-failure events
    prefill_fail_attempts: int = 2  # consecutive failures per event


# A plan is a list of {"kind", "step", ...} events sorted by step. Kept
# as plain dicts so benches can serialize it next to their counters.
FaultPlan = List[Dict[str, int]]


def build_fault_plan(cfg: FaultConfig) -> FaultPlan:
    """Seeded plan: same config -> same events, everywhere."""
    rng = np.random.default_rng(cfg.seed)
    events: FaultPlan = []

    def steps(n):
        lo, hi = 2, max(cfg.horizon_steps, 3)
        return sorted(int(s) for s in rng.integers(lo, hi, n))

    for s in steps(cfg.n_exhaust):
        events.append({"kind": "exhaust", "step": s,
                       "blocks": cfg.exhaust_blocks,
                       "hold": cfg.exhaust_hold_steps})
    for s, alias in zip(steps(cfg.n_corrupt),
                        rng.integers(0, 2, cfg.n_corrupt)):
        events.append({"kind": "corrupt", "step": s, "alias": int(alias)})
    for s in steps(cfg.n_nan):
        events.append({"kind": "nan", "step": s})
    for s in steps(cfg.n_prefill_fail):
        events.append({"kind": "prefill_fail", "step": s,
                       "attempts": cfg.prefill_fail_attempts})
    return sorted(events, key=lambda e: (e["step"], e["kind"]))


class FaultInjector:
    """Drives a FaultPlan against an engine, one scheduler step at a
    time. Call ``attach(engine)`` once, ``apply(engine, step)`` before
    every ``engine.step`` (run_replay does both), and ``finalize``
    after the drive loop to return any still-held blocks."""

    def __init__(self, plan: FaultPlan):
        self.pending: FaultPlan = sorted(plan,
                                         key=lambda e: (e["step"], e["kind"]))
        self.stats: Counter = Counter()
        self._holds: List[Dict[str, object]] = []  # {release, ids}
        self._nan_armed = 0
        self._fail_budget = 0
        self._engine = None

    # ---- engine hooks -------------------------------------------------
    def attach(self, engine) -> "FaultInjector":
        """Install the logits tap and prefill gate. The NaN family needs
        ``numerics_check=True`` on the engine to resolve to an explicit
        finish_reason (asserted here so a plan can't silently stream
        garbage tokens)."""
        if any(e["kind"] == "nan" for e in self.pending) \
                and not engine.numerics_check:
            raise ValueError(
                "FaultPlan injects NaN activations but the engine has "
                "numerics_check=False: the fault would stream garbage "
                "tokens instead of resolving to finish_reason='numerics'")
        self._engine = engine
        engine.logits_tap = self._tap
        engine.prefill_fault = self._prefill_gate
        return self

    def _tap(self, logits: np.ndarray, phase: str, step: int) -> np.ndarray:
        eng = self._engine
        if phase == "decode" and self._nan_armed > 0 and eng.active:
            slot = min(eng.active)          # deterministic victim
            logits = logits.copy()
            logits[slot, :] = np.nan
            self._nan_armed -= 1
            self.stats["nan"] += 1
        return logits

    def _prefill_gate(self, step: int, reqs) -> None:
        if self._fail_budget > 0:
            self._fail_budget -= 1
            self.stats["prefill_fail"] += 1
            raise TransientPrefillError(
                f"injected transient prefill failure at step {step}")

    # ---- per-step drive ----------------------------------------------
    def apply(self, engine, step: int) -> None:
        """Release due block holds, then fire every due event whose
        precondition holds; unmet events defer to the next step."""
        for h in [h for h in self._holds if h["release"] <= step]:
            engine.release_blocks(h["ids"])
            self._holds.remove(h)
        keep: FaultPlan = []
        for e in self.pending:
            if e["step"] > step or not self._fire(engine, e, step):
                keep.append(e)
        self.pending = keep

    def _fire(self, engine, e: Dict[str, int], step: int) -> bool:
        kind = e["kind"]
        if kind == "exhaust":
            if engine.kv_layout != "paged" or engine.free_blocks == 0:
                return False
            ids = engine.reserve_blocks(min(e["blocks"],
                                            engine.free_blocks))
            self._holds.append({"release": step + e["hold"], "ids": ids})
            self.stats["exhaust"] += 1
            return True
        if kind == "corrupt":
            if engine.kv_layout != "paged":
                return False
            owners = sorted(s for s in engine.active
                            if engine.owned_blocks(s))
            if not owners:
                return False
            slot = owners[0]
            bid = engine.kv_blocks + 3              # out of range
            if e["alias"]:                          # foreign live block
                others = [s for s in owners[1:]]
                if others:
                    bid = engine.owned_blocks(others[0])[0]
            engine.corrupt_table_entry(slot, 0, bid)
            self.stats["corrupt"] += 1
            return True
        if kind == "nan":
            if not engine.active:
                return False
            self._nan_armed += 1
            return True
        if kind == "prefill_fail":
            self._fail_budget += e["attempts"]
            self.stats["prefill_fail_events"] += 1
            return True
        raise ValueError(f"unknown fault kind {kind!r}")

    def finalize(self, engine) -> None:
        """Return any still-held blocks (a hold whose release step lies
        past the drain) so post-run KV accounting balances."""
        for h in self._holds:
            engine.release_blocks(h["ids"])
        self._holds.clear()

    def summary(self) -> Dict[str, int]:
        """Fired-fault counters (what actually hit the engine)."""
        return {k: int(v) for k, v in sorted(self.stats.items())}
