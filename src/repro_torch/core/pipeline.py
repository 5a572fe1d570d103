"""Cycle-accurate simulator of the unrolled pipelined online multiplier
(own copy of `repro/core/pipeline.py`).

The paper unrolls the n + delta iterations into n + delta + 1 pipeline
stages (the +1 is the output register). A stream of k operand pairs enters
one pair per cycle; pair i occupies stage (c - i) at cycle c. Total cycles
to drain: (n + delta + 1) + (k - 1)  — paper Table III.

Each stage is one step of the online recurrence, so the functional result
of the pipelined array is identical to running each pair through the
non-pipelined reference. What the simulator adds is the *per-cycle* view:
live bit-slices per stage (the Fig. 7 schedule applied to whichever pair
occupies the stage), register switching activity, and pipeline
utilization — the quantities behind the paper's area/power story.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .online_mul import OnlineMulState, OnlineMulTrace, working_precision
from .precision import OnlinePrecision

__all__ = ["PipelineRun", "run_pipeline", "stage_slice_schedule"]


def stage_slice_schedule(cfg: OnlinePrecision) -> List[int]:
    """Live fractional slices built in each unrolled stage (stage s runs
    step j = s - delta). The output stage (last) carries no datapath."""
    return [working_precision(cfg, s - cfg.delta) for s in range(cfg.steps)] + [0]


@dataclasses.dataclass
class PipelineRun:
    traces: List[OnlineMulTrace]       # per-pair results (== reference)
    cycles: int                        # total cycles to drain the stream
    active_slices_per_cycle: List[int]  # sum of live slices across stages
    flips_total: int                   # register switching activity
    stage_slices: List[int]            # structural slices per stage

    @property
    def peak_active(self) -> int:
        return max(self.active_slices_per_cycle) if self.active_slices_per_cycle else 0

    @property
    def utilization(self) -> float:
        """Mean occupied-stage fraction over the run."""
        if not self.active_slices_per_cycle:
            return 0.0
        total_struct = sum(self.stage_slices)
        return sum(self.active_slices_per_cycle) / (len(self.active_slices_per_cycle) * max(total_struct, 1))


def run_pipeline(
    pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
    cfg: OnlinePrecision,
) -> PipelineRun:
    """Stream k operand pairs through the unrolled pipeline.

    Args:
      pairs: sequence of (x_digits, y_digits), each n digits.
      cfg: multiplier precision configuration.

    Returns PipelineRun with per-pair traces and cycle-level activity.
    """
    k = len(pairs)
    n_stages = cfg.steps  # compute stages; +1 output register stage
    states: List[OnlineMulState | None] = [None] * k
    activity: List[int] = []
    flips_before = 0
    total_cycles = cfg.pipeline_latency + (k - 1) if k else 0

    for c in range(total_cycles):
        live = 0
        # pair i is in compute stage s = c - i for 0 <= s < n_stages
        lo = max(0, c - n_stages + 1)
        hi = min(k - 1, c)
        for i in range(lo, hi + 1):
            s = c - i
            if s >= n_stages:
                continue  # output register stage
            if states[i] is None:
                states[i] = OnlineMulState(cfg)
            st = states[i]
            assert st is not None and st.j == s - cfg.delta
            st.step(pairs[i][0], pairs[i][1])
            live += st.active[-1]
        activity.append(live)

    traces = []
    flips = 0
    for i, st in enumerate(states):
        assert st is not None and st.done, f"pair {i} did not drain"
        flips += st.flips
        traces.append(
            OnlineMulTrace(
                z_digits=st.z_digits,
                z_int=st.Z,
                residual_bound=st.wmax,
                active_per_step=st.active,
                selm_inputs=st.selm_inputs,
                flips=st.flips,
            )
        )
    return PipelineRun(
        traces=traces,
        cycles=total_cycles,
        active_slices_per_cycle=activity,
        flips_total=flips,
        stage_slices=stage_slice_schedule(cfg),
    )
