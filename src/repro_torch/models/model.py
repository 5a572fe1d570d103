"""Model facade of the dense decoder (port of `repro/models/model.py`):

  init(seed)                                   -> params
  init_cache(batch, max_len, paged=)           -> per-layer caches
  prefill(params, batch, cache, last_index=)   -> (last logits, cache, None)
  prefill_chunk(params, batch, cache, start, last_index=)
                                               -> (logits, cache)
  decode_step(params, token, pos, cache)       -> (logits, cache)

The model lives on one device, the CUDA card unless the caller passes
device="cpu". Weights are drawn from a seeded torch.Generator on that
device (jax.random's numbers cannot be reproduced; `convert.py` carries a
JAX parameter tree over instead).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import embed, embedding_init, rmsnorm, unembed
from .transformer import block_cache_init, block_init, stack_apply

Params = Dict[str, Any]

__all__ = ["Model", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or implied) and absent, so no
    entry point drifts onto the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, eng: Optional[DotEngine] = None, *,
                 device=None):
        self.cfg = cfg
        self.eng = eng or DotEngine(mode=cfg.dot_mode)
        self.device = resolve_device(device)

    def init(self, seed: int = 0) -> Params:
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params: Params = {
            "embed": embedding_init(gen, cfg, dev),
            "layers": [block_init(gen, cfg, dev) for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.ones((cfg.d_model,),
                                               dtype=cfg.pdtype, device=dev)},
            "unembed": embedding_init(gen, cfg, dev),
        }
        return params

    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[Dict[str, int]] = None) -> List[Params]:
        """paged={"num_blocks": NB, "block_size": bs} gives every layer a
        block-pool KV layout with one (batch, ceil(max_len/bs)) block
        table shared by all layers (all entries start at the trash block);
        the default is the contiguous per-lane layout."""
        shared = None
        if paged is not None:
            mbl = -(-max_len // paged["block_size"])
            shared = {**paged, "table": torch.zeros(
                (batch, mbl), dtype=torch.int32, device=self.device)}
        return [block_cache_init(self.cfg, batch, max_len, self.device,
                                 paged=shared)
                for _ in range(self.cfg.n_layers)]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["unembed"], x, cfg, self.eng.for_role("head"))
        return logits[:, 0].to(torch.float32)

    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: List[Params], last_index: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Params], None]:
        """Process prompts (B, S); returns (logits at each lane's
        `last_index` (or S-1), cache, None). Right-padded prompts are safe:
        causal attention masks the padding, and later decode steps
        overwrite its cache slots position for position."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = embed(params["embed"], tokens, cfg)
        x = stack_apply(params["layers"], cfg, x, pos, self.eng, caches=cache)
        return self._head(params, self._take_last(x, last_index)), cache, None

    @torch.no_grad()
    def prefill_chunk(self, params: Params, batch: Dict[str, torch.Tensor],
                      cache: List[Params], start,
                      last_index: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, List[Params]]:
        """Chunked prefill: run S prompt tokens starting at absolute
        position `start` (an int), attending over the contiguous cache's
        whole view so earlier chunks stay visible (the serving engine runs
        it on a fresh contiguous row cache). Returns (logits at
        `last_index` within the chunk (or S-1), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        pos = (int(start) + torch.arange(S, device=self.device))[None]
        pos = pos.expand(B, S)
        x = embed(params["embed"], tokens, cfg)
        x = stack_apply(params["layers"], cfg, x, pos, self.eng, caches=cache,
                        chunked=True)
        return self._head(params, self._take_last(x, last_index)), cache

    def _take_last(self, x: torch.Tensor,
                   last_index: Optional[torch.Tensor]) -> torch.Tensor:
        """Each lane's row at `last_index` (or the last), as (B, 1, d)."""
        if last_index is None:
            return x[:, -1:]
        idx = last_index.to(self.device, torch.int64)
        return x[torch.arange(x.shape[0], device=self.device), idx][:, None]

    @torch.no_grad()
    def decode_step(self, params: Params, token: torch.Tensor,
                    pos: torch.Tensor, cache: List[Params]
                    ) -> Tuple[torch.Tensor, List[Params]]:
        """token (B,), pos (B,) absolute position of `token`."""
        token = token.to(self.device)
        pos = pos.to(self.device)
        x = embed(params["embed"], token[:, None], self.cfg)
        x = stack_apply(params["layers"], self.cfg, x, pos[:, None], self.eng,
                        caches=cache)
        return self._head(params, x), cache
