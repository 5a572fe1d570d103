"""End-to-end serving CLI: continuous batching over a seeded request
stream, on the CUDA card unless --device says otherwise.

Defaults to the paged KV cache; --kv-layout contiguous selects the
contiguous layout, --kv-blocks / --kv-block-size size the paged pool, and
--prefill-chunk splits long prompts into decode-interleaved chunks.
Weights are drawn from --seed (no checkpoint is loaded).

Robustness knobs (see serving/engine.py): --max-queue bounds admission
(overflow sheds with finish_reason="rejected"), --deadline-steps gives
every request a scheduler-step budget, --no-preempt restores terminal
cache_full instead of preemption-with-recompute, --degrade-ladder names
a comma-separated downshift ladder of DotEngine modes (rung 0 = the
deployment base mode), and --numerics-check finishes NaN/Inf lanes with
finish_reason="numerics".

--arch takes any dense arch of `repro_torch.configs` (chatglm3_6b,
qwen1_5_110b, internlm2_1_8b, yi_34b, or their dashed aliases).

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
      --smoke --device cpu --requests 4 --slots 4 --max-new 4
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.report import ServeReport


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-layout", choices=("paged", "contiguous"),
                    default="paged")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="usable pool size + 1 (block 0 is the trash "
                         "block); default sizes the pool to ~half of "
                         "slots*max_len worth of tokens")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split long prompts into chunks of this many "
                         "tokens, interleaved with decode steps")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; overflow submits "
                         "finish with reason 'rejected'")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="scheduler-step budget per request; expired "
                         "requests finish with reason 'deadline'")
    ap.add_argument("--no-preempt", action="store_true",
                    help="terminal cache_full on block exhaustion "
                         "instead of preemption-with-recompute")
    ap.add_argument("--degrade-ladder", default=None,
                    help="comma-separated DotEngine-mode downshift "
                         "ladder, rung 0 = the base mode (e.g. "
                         "'olm16,olm16t12,olm16t10')")
    ap.add_argument("--numerics-check", action="store_true",
                    help="finish NaN/Inf lanes with reason 'numerics' "
                         "instead of streaming garbage tokens")
    ap.add_argument("--dot-mode", default=None, choices=DotEngine.modes(),
                    help="serve under this DotEngine mode (default: the "
                         "config's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, DotEngine(mode=args.dot_mode or cfg.dot_mode),
                  device=args.device)
    params = model.init(args.seed)
    ladder = (args.degrade_ladder.split(",")
              if args.degrade_ladder else None)
    engine = ServeEngine(model, params, slots=args.slots,
                         max_len=args.max_len, kv_layout=args.kv_layout,
                         kv_block_size=args.kv_block_size,
                         kv_blocks=args.kv_blocks,
                         prefill_chunk=args.prefill_chunk,
                         max_queue=args.max_queue,
                         preempt=not args.no_preempt,
                         numerics_check=args.numerics_check,
                         degrade_ladder=ladder, device=model.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 4))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new,
                              deadline_steps=args.deadline_steps))
    done = engine.run()
    rep = ServeReport.collect(engine, done)
    for r in done[:4]:
        tier = f", tier {r.served_tier}" if r.served_tier else ""
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> {len(r.output)} "
              f"new ({r.finish_reason}{tier})")
    print(json.dumps(rep))
    if len(done) != args.requests:
        raise SystemExit(f"engine answered {len(done)} of {args.requests} "
                         "requests")
    return rep


if __name__ == "__main__":
    main()
