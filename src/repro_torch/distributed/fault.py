"""Fault tolerance: preemption handling, straggler watchdog, restart logic
(own copy of `repro/distributed/fault.py`).

Designed for the 1000+ node regime where *something* is always failing:

  * PreemptionGuard — SIGTERM/SIGINT flips a flag; the train loop saves a
    final checkpoint and exits cleanly (checkpoint/restart recovery).
  * StragglerWatchdog — per-step wall-time EMA + z-score; flags outlier
    steps. On real clusters a flagged host triggers the configured policy
    (log | exclude-and-rescale | abort-for-reschedule). Exclusion uses the
    elastic restore path: reshape the mesh without the sick host and
    restore the latest checkpoint onto it.
  * retry_step — retries transient step failures (preempted collectives
    surface as RuntimeError) with exponential backoff before escalating.

The watchdog times what lies between start() and stop(). On the card a
train step returns once its kernels are queued, so the caller ends the
step in torch.cuda.synchronize() before stop(): otherwise the watchdog
times the launch, not the step (launch/train.py does).
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional

__all__ = ["PreemptionGuard", "StragglerWatchdog", "retry_step"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.preempted = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self.preempted = True


class StragglerWatchdog:
    """Step-time EMA + z-score straggler detector."""

    def __init__(self, *, alpha: float = 0.05, z_threshold: float = 4.0,
                 warmup_steps: int = 10,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.alpha = alpha
        self.z = z_threshold
        self.warmup = warmup_steps
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flagged: List[int] = []
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # seed statistics
            d = dt - self.mean
            self.mean += d / self.n
            self.var += d * (dt - self.mean)
            return False
        std = max((self.var / max(self.n - 1, 1)) ** 0.5, 1e-9)
        is_straggler = (dt - self.mean) / std > self.z
        if is_straggler:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt)
        # EMA update (outliers damped so one straggler doesn't poison stats)
        w = self.alpha * (0.1 if is_straggler else 1.0)
        self.mean = (1 - w) * self.mean + w * dt
        return is_straggler


def retry_step(fn, *args, retries: int = 2, backoff: float = 1.0):
    """Run fn(*args); on transient RuntimeError retry with backoff."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except RuntimeError as e:  # collectives on preempted peers
            last = e
            if attempt == retries:
                raise
            time.sleep(backoff * (2 ** attempt))
    raise last  # pragma: no cover
