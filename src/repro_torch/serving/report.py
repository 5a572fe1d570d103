"""ServeReport: the one serving metrics mapping (own copy of
`repro/serving/report.py`).

Canonical keys (producers set the subset that applies):

  n                 finished requests
  finish_reasons    {reason: count}
  ttft_*_s, e2e_*_s, queue_wait_mean_s, tokens_per_s
                    wall-clock latency metrics
  new_tokens, wall_s
  kv                nested kv_report mapping (collect())
  counters          nested engine event counters (collect())

The legacy `n_<finish reason>` keys (e.g. `n_cache_full`) stay readable
as aliases of `finish_reasons[<reason>]` with a 0 default; iteration and
JSON expose canonical keys only. An empty report equals `{}`.
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["ServeReport"]


class ServeReport(dict):
    _REASONS = frozenset({"eos", "length", "max_len", "cache_full",
                          "deadline", "rejected", "numerics", "failed"})

    def _resolve(self, key: str):
        """Canonical value for a legacy alias, or raise KeyError."""
        if (isinstance(key, str) and key.startswith("n_")
                and key[2:] in self._REASONS
                and dict.__contains__(self, "finish_reasons")):
            return dict.__getitem__(self, "finish_reasons").get(key[2:], 0)
        raise KeyError(key)

    def __getitem__(self, key):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        return self._resolve(key)

    def __contains__(self, key):
        if dict.__contains__(self, key):
            return True
        try:
            self._resolve(key)
            return True
        except KeyError:
            return False

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    @staticmethod
    def finish_reasons(done: List[Any]) -> Dict[str, int]:
        """{reason: count} over a finished-request list."""
        reasons: Dict[str, int] = {}
        for r in done:
            key = r.finish_reason or "unknown"
            reasons[key] = reasons.get(key, 0) + 1
        return reasons

    @classmethod
    def collect(cls, engine, done: List[Any]) -> "ServeReport":
        """Full deployment report: latency surface plus the nested `kv`
        residency mapping and the engine's event `counters`."""
        rep = cls(engine.latency_report(done))
        rep["kv"] = dict(engine.kv_report())
        rep["counters"] = dict(engine.counters)
        return rep
