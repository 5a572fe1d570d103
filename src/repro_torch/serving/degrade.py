"""Graceful tier degradation under resource pressure (own copy of
`repro/serving/degrade.py`).

The paper's variable-precision digit slices exist so an inner-product
array can trade accuracy for activity when resources are tight; the
`olm{n}t{p}` truncated modes made that a servable quality tier.
This module turns the tier axis into a pressure valve: a configurable
**downshift ladder** of registered DotEngine modes, walked one rung at a
time when the engine is under KV-block or admission-queue pressure —
the serving-side analogue of the approximate-multiplier accuracy/energy
ladder (arxiv 2301.12181).

Rung 0 is the deployment's base mode; rungs 1..R-1 are progressively
cheaper (typically truncated) modes. Every rung must be a registered
DotEngine mode, so `olm_error_bound` stays guaranteed per served tier —
a degraded request is served *exactly* as a dedicated deployment at
that mode would serve it, just with `Request.served_tier` recording the
downgrade.

Downshifts happen at two boundaries (both in ServeEngine):

  * **submit overflow** — a bounded admission queue would shed the
    request with ``finish_reason="rejected"``; with a ladder configured
    and headroom left, the request is re-admitted one rung down
    instead.
  * **preemption requeue** — a preempted lane re-enters the queue; if
    KV-block pressure is above threshold (``free_frac``), it re-admits
    one rung down so its recompute and remaining decode run cheaper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

__all__ = ["DegradeLadder"]


@dataclasses.dataclass(frozen=True)
class DegradeLadder:
    """Validated tier-downshift ladder.

    ladder     registered DotEngine mode names, rung 0 = the base mode
    free_frac  preempt-requeue downshift threshold: pressure when
               free_blocks / usable_blocks < free_frac
    queue_headroom  extra queue slots granted to degraded re-admission
               past the hard max_queue bound (0 disables re-admission
               of overflow submits)
    """
    ladder: Tuple[str, ...]
    free_frac: float = 0.25
    queue_headroom: int = 1

    @staticmethod
    def build(ladder: Sequence[str], *, base_mode: str,
              free_frac: float = 0.25,
              queue_headroom: int = 1) -> "DegradeLadder":
        from repro_torch.core.numerics import DotEngine
        rungs = tuple(ladder)
        if len(rungs) < 2:
            raise ValueError(
                "degrade_ladder needs >= 2 rungs (base + one downshift "
                f"target); got {list(rungs)}")
        known = DotEngine.modes()
        if bad := [m for m in rungs if m not in known]:
            raise ValueError(
                f"degrade_ladder rungs {bad} are not registered DotEngine "
                f"modes (have {sorted(known)}); every rung must carry a "
                "documented olm_error_bound")
        if rungs[0] != base_mode:
            raise ValueError(
                f"degrade_ladder rung 0 must be the deployment base mode "
                f"{base_mode!r}, got {rungs[0]!r} — the ladder is a "
                "downshift from what the request would otherwise get")
        if len(set(rungs)) != len(rungs):
            raise ValueError(f"degrade_ladder has duplicate rungs: "
                             f"{list(rungs)}")
        if not 0.0 <= free_frac <= 1.0:
            raise ValueError(f"free_frac must be in [0, 1], got {free_frac}")
        if queue_headroom < 0:
            raise ValueError("queue_headroom must be >= 0")
        return DegradeLadder(rungs, free_frac, queue_headroom)

    def rung_of(self, mode: Optional[str]) -> int:
        """Ladder rung of a mode name (requests whose tier mode is not a
        rung start from rung 0 — the ladder is relative to base)."""
        if mode is not None and mode in self.ladder:
            return self.ladder.index(mode)
        return 0

    def next_mode(self, rung: int) -> Optional[str]:
        """Mode one rung down, or None if already at the bottom."""
        if rung + 1 < len(self.ladder):
            return self.ladder[rung + 1]
        return None

    def kv_pressure(self, free_blocks: int, usable_blocks: int) -> bool:
        """KV-block pressure predicate for the preempt-requeue boundary
        (contiguous layouts have no block pool: never under pressure)."""
        if usable_blocks <= 0:
            return False
        return free_blocks < self.free_frac * usable_blocks
