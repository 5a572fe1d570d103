"""End-to-end serving CLI: continuous batching over a seeded request
stream, on the CUDA card unless --device says otherwise.

Defaults to the paged KV cache; --kv-layout contiguous selects the
contiguous layout, --kv-blocks / --kv-block-size size the paged pool.
Weights are drawn from --seed (no checkpoint is loaded).

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
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
    engine = ServeEngine(model, params, slots=args.slots,
                         max_len=args.max_len, kv_layout=args.kv_layout,
                         kv_block_size=args.kv_block_size,
                         kv_blocks=args.kv_blocks, device=model.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 4))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    done = engine.run()
    rep = ServeReport.collect(engine, done)
    for r in done[:4]:
        print(f"req {r.rid}: prompt {len(r.prompt)} toks -> {len(r.output)} "
              f"new ({r.finish_reason})")
    print(json.dumps(rep))
    if len(done) != args.requests:
        raise SystemExit(f"engine answered {len(done)} of {args.requests} "
                         "requests")
    return rep


if __name__ == "__main__":
    main()
