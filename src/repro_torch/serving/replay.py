"""Deterministic traffic-replay harness for the serving engine (own copy
of `repro/serving/replay.py`).

A seeded arrival process generates a fixed workload (arrival step, prompt,
max_new_tokens per request); `run_replay` drives a ServeEngine one
scheduler step at a time, submitting requests when their arrival step
comes up, and reports latency percentiles in **scheduler steps** - the
engine's virtual clock - rather than wall time. Step metrics are a pure
function of the workload and the scheduler logic (requests use
eos_id=None, so termination never depends on sampled token values), so
they are the same on any host, device or width: the port reproduces the
counters the reference committed in `results/baseline/`
(BENCH_serve_replay.json, BENCH_serve_faults.json). `build_workload` is
a copy of the reference's numpy-seeded generator and gives the same
schedule for the same config.

A replay optionally carries a :class:`~repro_torch.serving.faults.FaultInjector`
(``run_replay(..., faults=...)``): faults are applied at each step
boundary *before* the engine steps, so a given (workload seed, fault
plan) pair resolves identically every run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import Request, ServeEngine
from .faults import FaultInjector
from .report import ServeReport

__all__ = ["ReplayConfig", "build_workload", "run_replay", "step_report"]


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    seed: int = 0
    n_requests: int = 24
    mean_interarrival_steps: float = 2.0
    prompt_len_range: Tuple[int, int] = (4, 24)   # inclusive
    max_new_range: Tuple[int, int] = (4, 10)      # inclusive
    vocab: int = 512
    # Deadlines: every deadline_every-th request (1-indexed; 0 = none)
    # gets a deadline of deadline_steps scheduler steps. Defaults keep
    # pre-existing seeded workloads byte-identical.
    deadline_every: int = 0
    deadline_steps: int = 0
    # Priorities: cycle request priority over 0..priority_levels-1
    # (1 = all equal, the default) to exercise victim selection.
    priority_levels: int = 1


def build_workload(cfg: ReplayConfig) -> List[Dict[str, object]]:
    """Seeded arrival schedule: [{arrival_step, prompt, max_new}, ...],
    sorted by arrival. numpy Generator bit streams are stable across
    numpy versions, so the same seed is the same workload everywhere."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.geometric(1.0 / max(cfg.mean_interarrival_steps, 1.0),
                         cfg.n_requests) - 1
    arrivals = np.cumsum(gaps)
    lo, hi = cfg.prompt_len_range
    lens = rng.integers(lo, hi + 1, cfg.n_requests)
    nlo, nhi = cfg.max_new_range
    max_new = rng.integers(nlo, nhi + 1, cfg.n_requests)
    out: List[Dict[str, object]] = []
    for i in range(cfg.n_requests):
        w: Dict[str, object] = {
            "arrival_step": int(arrivals[i]),
            "prompt": rng.integers(1, cfg.vocab, int(lens[i])).astype(np.int32),
            "max_new": int(max_new[i]),
        }
        if cfg.deadline_every and (i + 1) % cfg.deadline_every == 0:
            w["deadline_steps"] = int(cfg.deadline_steps)
        if cfg.priority_levels > 1:
            w["priority"] = int(i % cfg.priority_levels)
        out.append(w)
    return out


def run_replay(engine: ServeEngine, workload: List[Dict[str, object]],
               *, max_steps: int = 100_000,
               faults: Optional[FaultInjector] = None,
               ) -> Tuple[List[Request], ServeReport]:
    """Drive the engine through the workload; returns (done, step_report).

    The report is a :class:`~repro_torch.serving.report.ServeReport` — virtual-
    clock step metrics plus the unified counter surface (finish_reasons /
    preempts / retries / degrades, legacy ``n_*`` keys readable as
    aliases) and ``wall_s``. Deliberately NO wall-clock latency fields
    beyond wall_s: the chaos bench diffs every non-wall_s entry exactly
    across runs, so everything here must be a pure function of the
    (workload, fault plan, engine config) triple.

    Requests are submitted when the engine's step counter reaches their
    arrival step, so queueing pressure replays identically every run.
    With a FaultInjector, fault events fire at the step boundary right
    after that step's submissions — deterministic in the virtual clock.
    """
    pending = sorted(workload, key=lambda w: w["arrival_step"])
    reqs = [Request(rid=i, prompt=w["prompt"], max_new_tokens=w["max_new"],
                    eos_id=None,
                    deadline_steps=w.get("deadline_steps"),
                    priority=w.get("priority", 0))
            for i, w in enumerate(pending)]
    if faults is not None:
        faults.attach(engine)
    done: List[Request] = []
    i = 0
    t0 = time.monotonic()
    for _ in range(max_steps):
        while i < len(pending) and \
                pending[i]["arrival_step"] <= engine.step_count:
            engine.submit(reqs[i])
            i += 1
        if faults is not None:
            faults.apply(engine, engine.step_count)
        if i == len(pending) and not engine.queue and not engine.active \
                and engine.pending_chunk is None:
            # fully drained: deferred fault events can never fire now
            break
        engine.step(done)
    if faults is not None:
        faults.finalize(engine)
    engine._drain_shed(done)
    wall_s = time.monotonic() - t0
    report = step_report(done)
    report["wall_s"] = wall_s
    return done, report


def step_report(done: List[Request]) -> ServeReport:
    """Latency percentiles in scheduler steps (deterministic; see module
    docstring). p50/p99 use numpy's default linear interpolation.

    Returns a ServeReport: per-reason counts live under the one
    `finish_reasons` mapping and the robustness counters under their
    canonical names (preempts/retries/degrades); the historical
    `n_cache_full` / `n_preempts` / ... spellings stay readable as
    ServeReport aliases."""
    if not done:
        return ServeReport()

    def pcts(vals):
        return (round(float(np.percentile(vals, 50)), 4),
                round(float(np.percentile(vals, 99)), 4))

    ttft = [r.s_first - r.s_submit for r in done if r.s_first is not None]
    e2e = [r.s_done - r.s_submit for r in done if r.s_done is not None]
    ttft_p50, ttft_p99 = pcts(ttft) if ttft else (float("nan"),) * 2
    e2e_p50, e2e_p99 = pcts(e2e) if e2e else (float("nan"),) * 2
    new_tokens = sum(len(r.output) for r in done)
    steps = max(max((r.s_done for r in done if r.s_done is not None),
                    default=1), 1)
    return ServeReport({
        "n": len(done),
        "finish_reasons": ServeReport.finish_reasons(done),
        "ttft_steps_p50": ttft_p50,
        "ttft_steps_p99": ttft_p99,
        "e2e_steps_p50": e2e_p50,
        "e2e_steps_p99": e2e_p99,
        "new_tokens": new_tokens,
        "steps_total": steps,
        "tokens_per_step": round(new_tokens / steps, 4),
        "preempts": sum(r.n_preempts for r in done),
        "retries": sum(r.n_retries for r in done),
        "degrades": sum(r.degrade_rung > 0 for r in done),
    })
