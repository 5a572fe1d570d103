"""Shape-aware launch-plan autotuner for the online-array matmul (port of
`repro/kernels/online_dot/tuning.py`).

On Hopper the knobs of K1 and K2 (`matmul_kernel.launch_plan`) are a
block's rows `block_m` (the plan's bm), its columns `block_n` (bn) and the
K tiles it runs at once, `tb`; k_tile, the array width, is a numerics
parameter and stays pinned. The autotuner looks a plan up by power-of-two
buckets of (M, N, K, n_bits), as the reference does:

  * `get_tiling(M, N, K, n_bits)` - the lookup `DotEngine(tiling="auto")`
    makes for each GEMM. A hit returns the stored entry (measured if
    `tune` ran, else the memoized heuristic); a miss computes
    `heuristic_tiling` and memoizes it in memory, so the next GEMM of the
    bucket is a hit.
  * `tune(M, N, K, n_bits)` - times a small candidate set around the
    heuristic with `olm_matmul(quantize="kernel")` on the card and
    persists the winner.
  * `TuningCache` - the JSON store, by default `results/tuning_torch.json`
    (`REPRO_TORCH_TUNING_CACHE` overrides). Its header names the card the
    entries were measured on; a cache reads no entry of another card.

Nothing here can change the bits: block shapes only re-tile the output
(K tiles add in tile order whatever the block), and k_tile is re-pinned
to the kernel's numerics default (`pinned_k_tile`) on every read.
`heuristic_tiling` is the planner's own choice, so with no cache entry
`tiling="auto"` launches what `tiling=None` without pins launches. A
candidate is legal when bm, bn and tb are powers of two, the block has 32
to 256 threads and its shared memory fits (`matmul_kernel.fits`) and, on
the card, it holds at least one block an SM (`matmul_kernel.geometry`);
a read entry that is not legal for K1 is re-planned by the heuristic and
never launched.

CLI, on the card:

  PYTHONPATH=src python -m repro_torch.kernels.online_dot.tuning \\
      [--cache results/tuning_torch.json] [--heuristic-only] [--cap 4096] \\
      [--n-bits 8,16,24,32,16t12,...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.common import DECODE_WINDOW_F32, DECODE_WINDOW_WIDE
from . import matmul_kernel
from .ref import tree_levels

__all__ = ["Tiling", "TuningCache", "bucket", "bucket_key", "decode_window",
           "max_k_tile", "pinned_k_tile", "heuristic_tiling", "legal",
           "get_tiling", "tune", "default_cache", "DEFAULT_CACHE_PATH"]

# Anchored to the repo root, not the working directory, so a tuning run
# and a serving process launched anywhere agree on where the cache lives.
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", ".."))
DEFAULT_CACHE_PATH = os.path.join(_REPO_ROOT, "results", "tuning_torch.json")
CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
H100_SMS = 132


def decode_window(n_bits: int) -> int:
    """Per-dtype exact decode window the tuner keeps streams inside: 24
    digits (plain f32) for n <= 16, 48 (the wide decode) for n = 24/32."""
    return DECODE_WINDOW_F32 if n_bits <= 16 else DECODE_WINDOW_WIDE


@dataclasses.dataclass(frozen=True)
class Tiling:
    """One launch plan of K1/K2: k_tile lanes a K tile (numerics, pinned),
    blocks of block_m rows x block_n columns x tb K tiles."""
    k_tile: int
    block_m: int
    block_n: int
    tb: int

    def as_dict(self) -> Dict[str, int]:
        return {"k_tile": self.k_tile, "block_m": self.block_m,
                "block_n": self.block_n, "tb": self.tb}

    def label(self) -> str:
        return f"{self.block_m}x{self.block_n}x{self.tb}"


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def bucket(v: int) -> int:
    """Shape bucket: the next power of two (>= 1)."""
    return _pow2_ceil(max(1, v))


def bucket_key(M: int, N: int, K: int, n_bits: int,
               trunc: Optional[int] = None) -> str:
    """Cache key for one (shape bucket, numerics) pair; a truncated
    `olm{n}t{p}` mode keys its own `t{p}` bucket."""
    suffix = "" if trunc is None else f"t{trunc}"
    return f"m{bucket(M)}n{bucket(N)}k{bucket(K)}b{n_bits}{suffix}"


def max_k_tile(n_bits: int) -> int:
    """Largest power-of-two k_tile whose dot stream still decodes exactly
    on this width's decode path: n_bits + 2*ceil(log2 kt) <= window."""
    window = decode_window(n_bits)
    kt = 1
    while n_bits + 2 * tree_levels(kt * 2) <= window:
        kt *= 2
    return kt


def pinned_k_tile(K: int, n_bits: int) -> int:
    """The k_tile `tiling="auto"` always serves: the kernel's numerics
    default clamped to the K bucket and the decode window."""
    from .matmul import DEFAULT_K_TILE
    return min(DEFAULT_K_TILE, _pow2_ceil(K), max_k_tile(n_bits))


def heuristic_tiling(M: int, N: int, K: int, n_bits: int,
                     trunc: Optional[int] = None,
                     sms: int = H100_SMS) -> Tiling:
    """The plan K1's planner picks for the shape with nothing pinned
    (`matmul_kernel.launch_plan` at the working digits), at the pinned
    k_tile: what `olm_matmul` launches today."""
    work = n_bits if trunc is None else trunc
    kt = pinned_k_tile(K, work)
    p = matmul_kernel.launch_plan(M, N, K, work, k_tile=kt, sms=sms)
    return Tiling(kt, p.bm, p.bn, p.tb)


def legal(t: Tiling, n_bits: int, trunc: Optional[int] = None) -> bool:
    """Whether K1 launches the plan as it stands (`olm_matmul` checks K2's
    larger stage itself)."""
    work = n_bits if trunc is None else trunc
    return matmul_kernel.fits(work, False, False, t.block_m, t.block_n, t.tb)


def _current_card() -> str:
    """The name of the card this process serves on, "cpu" without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


def _card_header(device: torch.device) -> dict:
    """Name, power limit (as nvidia-smi gives it) and SM count of the card
    a tuning run measures on."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "sms": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    props = torch.cuda.get_device_properties(device)
    return {"name": torch.cuda.get_device_name(device), "power_limit": out,
            "sms": props.multi_processor_count}


class TuningCache:
    """Persistent (bucket key -> plan entry) store with hit/miss accounting.
    The file is {"card": {"name", "power_limit", "sms"}, "entries": {key:
    entry}}, an entry a plain JSON dict:

      {"k_tile": .., "block_m": .., "block_n": .., "tb": ..,
       "source": "measured" | "heuristic", "shape": [M, N, K],
       "n_bits": .., "trunc": .. (truncated modes only),
       "us": .. (measured only)}

    `card` is the card this cache serves (the current one by default):
    the entries of a file measured on another card are not read, and
    their lookups count as misses. Disk writes happen only through
    `save()` (the `tune` path); the heuristic's memoization stays in
    memory."""

    def __init__(self, path: Optional[str] = None,
                 card: Optional[str] = None):
        self.path = path if path is not None else os.environ.get(
            CACHE_ENV, DEFAULT_CACHE_PATH)
        self.card = card if card is not None else _current_card()
        self.header = {"name": self.card, "power_limit": None, "sms": None}
        if card is None and torch.cuda.is_available():
            self.header["sms"] = torch.cuda.get_device_properties(
                torch.cuda.current_device()).multi_processor_count
        self.hits = 0
        self.misses = 0
        self._entries: Optional[Dict[str, dict]] = None

    # -- storage --
    def _load(self) -> Dict[str, dict]:
        if self._entries is None:
            self._entries = {}
            if self.path and os.path.exists(self.path):
                with open(self.path) as f:
                    data = json.load(f)
                header = data.get("card") or {}
                if header.get("name") == self.card:
                    self.header = {**self.header, **header}
                    self._entries = dict(data.get("entries", {}))
        return self._entries

    def save(self) -> None:
        entries = self._load()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"card": self.header, "entries": entries}, f,
                      indent=1, sort_keys=True)

    @property
    def sms(self) -> int:
        return self.header.get("sms") or H100_SMS

    # -- lookup API --
    def lookup(self, M: int, N: int, K: int, n_bits: int,
               trunc: Optional[int] = None) -> Optional[Tiling]:
        e = self._load().get(bucket_key(M, N, K, n_bits, trunc))
        if e is None:
            self.misses += 1
            return None
        self.hits += 1
        return Tiling(e["k_tile"], e["block_m"], e["block_n"], e.get("tb", 0))

    def store(self, M: int, N: int, K: int, n_bits: int, tiling: Tiling,
              *, source: str, trunc: Optional[int] = None,
              us: Optional[float] = None) -> None:
        entry = {**tiling.as_dict(), "source": source,
                 "shape": [M, N, K], "n_bits": n_bits}
        if trunc is not None:
            entry["trunc"] = trunc
        if us is not None:
            entry["us"] = round(us, 2)
        self._load()[bucket_key(M, N, K, n_bits, trunc)] = entry


_DEFAULT_CACHE: Optional[TuningCache] = None


def default_cache() -> TuningCache:
    """The process-wide cache `tiling="auto"` reads (made at first use, so
    REPRO_TORCH_TUNING_CACHE set before then is honored)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = TuningCache()
    return _DEFAULT_CACHE


def get_tiling(M: int, N: int, K: int, n_bits: int,
               cache: Optional[TuningCache] = None,
               trunc: Optional[int] = None) -> Dict[str, int]:
    """Measured-or-heuristic launch plan of one GEMM shape (the
    `tiling="auto"` entry point). A miss falls back to `heuristic_tiling`
    and memoizes it in memory. k_tile is re-pinned on every read, and an
    entry K1 would not launch (another layout, a hand edit) is answered
    with the heuristic, so no cache file can change what is computed or
    launch an illegal block."""
    cache = cache or default_cache()
    pinned = pinned_k_tile(K, n_bits if trunc is None else trunc)
    hit = cache.lookup(M, N, K, n_bits, trunc)
    if hit is not None and legal(hit, n_bits, trunc):
        return {**hit.as_dict(), "k_tile": pinned}
    t = heuristic_tiling(M, N, K, n_bits, trunc, sms=cache.sms)
    if hit is None:
        cache.store(M, N, K, n_bits, t, source="heuristic", trunc=trunc)
    return {**t.as_dict(), "k_tile": pinned}


def _candidates(M: int, N: int, K: int, n_bits: int,
                trunc: Optional[int] = None, *, sms: int = H100_SMS,
                on_card: bool = False) -> List[Tiling]:
    """The heuristic, the reference's static 8 x 8 block (as the planner
    completes it) and the plans one halving or doubling of a knob, or a
    doubling of one and a halving of another, away from the heuristic,
    each within its output dimension (bm <= M's, bn <= N's, tb <= the K
    tiles' power of two, unless the heuristic is already past it) and
    legal for K1 (on the card also by `matmul_kernel.geometry`);
    deduplicated and sorted. k_tile is the heuristic's for all."""
    work = n_bits if trunc is None else trunc
    base = heuristic_tiling(M, N, K, n_bits, trunc, sms=sms)
    kt = base.k_tile
    static = matmul_kernel.launch_plan(M, N, K, work, k_tile=kt, sms=sms,
                                       bm=8, bn=8)
    knobs = (base.block_m, base.block_n, base.tb)
    caps = [max(k, c) for k, c in zip(
        knobs, (bucket(M), bucket(N), bucket(-(-K // min(kt, K)))))]
    moves = [(i, f) for i in range(3) for f in (0.5, 2)]
    moves += [((i, 2), (j, 0.5)) for i in range(3) for j in range(3) if i != j]
    cands = {base, Tiling(kt, static.bm, static.bn, static.tb)}
    for move in moves:
        shape = list(knobs)
        for i, f in (move if isinstance(move[0], tuple) else (move,)):
            shape[i] = int(shape[i] * f)
        t = Tiling(kt, *shape)
        if (min(shape) >= 1 and all(s <= c for s, c in zip(shape, caps))
                and legal(t, n_bits, trunc)):
            cands.add(t)
    if on_card:
        L = tree_levels(min(kt, K))
        cands = {t for t in cands if matmul_kernel.geometry(
            work, False, False, t.block_m, t.block_n, t.tb, L)[1] >= 1}
    return sorted(cands, key=lambda t: (t.k_tile, t.block_m, t.block_n,
                                        t.tb))


# Bytes overwritten before each timed launch: more than 5x the H100's
# 50 MB L2, so every operand is read from device memory.
_FLUSH_BYTES = 256 << 20
_SPIN_CYCLES = 1_000_000


def _cuda_ms(fn, repeat: int, device: torch.device):
    """(median milliseconds, last output) of `repeat` launches of fn()
    after one warm-up, each between its own pair of CUDA events, with the
    L2 overwritten before each and a spin kernel keeping the stream busy
    while the host enqueues (so each pair times the device alone)."""
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    out = fn()
    spans = []
    with torch.cuda.device(device):
        for _ in range(repeat):
            flush.zero_()
            torch.cuda._sleep(_SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            spans.append((start, stop))
        torch.cuda.synchronize(device)
    return statistics.median(a.elapsed_time(b) for a, b in spans), out


def _cpu_ms(fn, repeat: int):
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def tune(M: int, N: int, K: int, n_bits: int,
         cache: Optional[TuningCache] = None, *,
         trunc: Optional[int] = None, cap: int = 4096, repeat: int = 5,
         save: bool = True, device=None,
         trace: Optional[list] = None) -> Tiling:
    """Time every candidate plan of one GEMM bucket and persist the winner
    with its time in microseconds.

    Candidates come from the real shape. The real N and K are measured;
    M is capped at `cap` rows, raised where a candidate's grid would not
    give every SM a block (the bucket key still records the real M). On
    the card (the default device) each candidate runs
    `olm_matmul(quantize="kernel")` under its plan: the median of `repeat`
    launches, each between CUDA events with the L2 overwritten before it.
    With device="cpu" every candidate runs the plain version, which
    ignores plans: that drives the control flow in the CPU tests, and its
    times say nothing of the card. A list given as `trace` receives
    (candidate, milliseconds, output of its last launch) for every
    candidate, in order."""
    from repro_torch.models.model import resolve_device
    from .matmul import olm_matmul
    if repeat < 5:
        raise ValueError(f"repeat={repeat}: a median needs at least 5 "
                         "launches")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cache = cache or default_cache()
    header = _card_header(dev)
    if header["name"] != cache.card:
        raise ValueError(f"tuning on {header['name']} into a cache of "
                         f"{cache.card}")
    sms = header["sms"] or H100_SMS
    cands = _candidates(M, N, K, n_bits, trunc, sms=sms, on_card=on_card)
    fill = max(c.block_m * -(-sms // -(-N // c.block_n)) for c in cands)
    Mc = min(M, max(cap, fill))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(Mc, K, generator=gen, device=dev)
    w = torch.randn(K, N, generator=gen, device=dev) * (2.0 / (K + N)) ** 0.5
    best, best_ms = None, float("inf")
    for cand in cands:
        def run(cand=cand):
            return olm_matmul(x, w, n_bits=n_bits, trunc=trunc,
                              quantize="kernel", k_tile=cand.k_tile,
                              block_m=cand.block_m, block_n=cand.block_n,
                              tb=cand.tb)
        ms, out = (_cuda_ms(run, repeat, dev) if on_card
                   else _cpu_ms(run, repeat))
        if trace is not None:
            trace.append((cand, ms, out))
        del out
        if ms < best_ms:
            best, best_ms = cand, ms
    cache.header = header
    cache.store(M, N, K, n_bits, best, source="measured", trunc=trunc,
                us=best_ms * 1e3)
    if save:
        cache.save()
    return best


# ---------------------------------------------------------------- CLI


def _launch_gemms() -> List[tuple]:
    """The reference's representative (M, N, K) GEMMs of the
    launch/shapes.py shape set: per shape case the row count its kind
    feeds the engine (decode = global_batch, train/prefill =
    batch * seq), crossed with a transformer block's projections at
    d_model 1024 and 4096 (d->d, d->4d and 4d->d)."""
    from repro_torch.launch.shapes import SHAPES
    gemms = set()
    for case in SHAPES.values():
        rows = (case.global_batch if case.kind == "decode"
                else case.global_batch * case.seq_len)
        for d in (1024, 4096):
            gemms.update({(rows, d, d), (rows, 4 * d, d), (rows, d, 4 * d)})
    return sorted(gemms)


def gemm_shapes(cfg) -> List[tuple]:
    """The (K, N) of every eng.dot GEMM one pass of `cfg` issues: q, k, v
    and o of an attention (self or cross), the MLP's projections (none on
    a MoE layer, whose experts are plain matmuls), an RG-LRU's wx, wy and
    wo, an SSD's win and wout, the encoder's layers and the LM head."""
    d, q, kv = cfg.d_model, cfg.d_head_total, cfg.d_kv_total
    attn = {(d, q), (d, kv), (q, d)}
    mlp = {(d, cfg.d_ff), (cfg.d_ff, d)}
    w = cfg.rnn_width or d
    din, H = cfg.d_inner, cfg.ssm_nheads
    per_kind = {
        "attn": attn | (set() if cfg.n_experts else mlp),
        "cross": attn | mlp, "xdec": attn | mlp,
        "rec": {(d, w), (w, d)} | mlp,
        "ssm": {(d, 2 * din + 2 * cfg.ssm_state + H), (din, d)}}
    shapes = {(d, cfg.vocab_padded)}
    for kind in set(cfg.layer_kinds):
        shapes |= per_kind[kind]
    if cfg.n_enc_layers:
        shapes |= attn | mlp
    return sorted(shapes)


def _serve_gemms() -> List[tuple]:
    """(M, N, K) of every eng.dot GEMM of every config the port serves, at
    a 4-lane decode and a 64-row prefill."""
    from repro_torch.configs import get_config, list_archs
    gemms = set()
    for arch in list_archs():
        for K, N in gemm_shapes(get_config(arch)):
            gemms.update({(4, N, K), (64, N, K)})
    return sorted(gemms)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="measure K1's launch plans on the card for the "
                    "launch/shapes.py GEMMs and every served config's, "
                    "into the port's tuning cache")
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default {DEFAULT_CACHE_PATH} or "
                         f"${CACHE_ENV})")
    ap.add_argument("--cap", type=int, default=4096,
                    help="rows a measurement runs at most (raised where a "
                         "candidate's grid would leave an SM idle)")
    ap.add_argument("--heuristic-only", action="store_true",
                    help="record the planner's plans without measuring")
    ap.add_argument("--n-bits", default="8,16,24,32",
                    help="comma-separated digit widths to tune; truncated "
                         "modes as n't'p tokens, e.g. 16t12,32t20")
    args = ap.parse_args(argv)
    cache = TuningCache(args.cache)
    widths = []                       # (n_bits, trunc-or-None) pairs
    for tok in args.n_bits.split(","):
        nb, _, tp = tok.strip().partition("t")
        widths.append((int(nb), int(tp) if tp else None))
    seen = set()
    t0 = time.monotonic()
    for (M, N, K) in sorted(set(_launch_gemms()) | set(_serve_gemms())):
        for nb, tp in widths:
            key = bucket_key(M, N, K, nb, tp)
            if key in seen:
                continue
            seen.add(key)
            if args.heuristic_only:
                t = heuristic_tiling(M, N, K, nb, tp)
                cache.store(M, N, K, nb, t, source="heuristic", trunc=tp)
                print(f"{key}: heuristic {t.as_dict()}", flush=True)
                continue
            trace: list = []
            t = tune(M, N, K, nb, cache, trunc=tp, cap=args.cap, save=False,
                     trace=trace)
            base = heuristic_tiling(M, N, K, nb, tp, sms=cache.sms)
            times = {c.label(): round(ms, 4) for c, ms, _ in trace}
            print(f"{key} M,N,K={(M, N, K)}: heuristic {base.label()} "
                  f"{times[base.label()]} ms, measured {t.label()} "
                  f"{times[t.label()]} ms; all {times} "
                  f"({time.monotonic() - t0:.0f} s)", flush=True)
            del trace
    cache.save()
    print(f"wrote {len(seen)} entries to {cache.path} for {cache.card}")


if __name__ == "__main__":
    main()
