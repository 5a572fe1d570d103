"""Model facade of the dense decoder (port of `repro/models/model.py`):

  init(seed)                                   -> params
  forward(params, batch)                       -> (logits (B, S, V), aux)
  init_cache(batch, max_len, paged=)           -> per-layer caches
  prefill(params, batch, cache, last_index=)   -> (last logits, cache, None)
  prefill_chunk(params, batch, cache, start, last_index=)
                                               -> (logits, cache)
  decode_step(params, token, pos, cache)       -> (logits, cache)

The model lives on one device, the CUDA card unless the caller passes
device="cpu". Weights are drawn from a seeded torch.Generator on that
device (jax.random's numbers cannot be reproduced; `convert.py` carries a
JAX parameter tree over instead). `lm_loss` is the causal LM loss over
`forward`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import embed, embedding_init, rmsnorm, unembed
from .transformer import block_cache_init, block_init, stack_apply

Params = Dict[str, Any]

__all__ = ["Model", "lm_loss", "resolve_device"]


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
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embedding_init(gen, cfg, dev)
        return params

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of tokens (B, S): (f32 logits (B, S,
        vocab_padded), aux loss). Not under no_grad, so a training step
        can take gradients through it."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = embed(params["embed"], tokens, cfg)
        x, aux = stack_apply(params["layers"], cfg, x, pos, self.eng)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(self._head_table(params), x, cfg,
                         self.eng.for_role("head"))
        return logits.to(torch.float32), aux

    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[Dict[str, int]] = None) -> List[Params]:
        """paged={"num_blocks": NB, "block_size": bs} gives every layer
        without a sliding window a block-pool KV layout with one
        (batch, ceil(max_len/bs)) block table shared by those layers (all
        entries start at the trash block); window layers keep their
        contiguous rings. The default is the contiguous per-lane layout."""
        shared = None
        if paged is not None and self.cfg.sliding_window is None:
            mbl = -(-max_len // paged["block_size"])
            shared = {**paged, "table": torch.zeros(
                (batch, mbl), dtype=torch.int32, device=self.device)}
        return [block_cache_init(self.cfg, batch, max_len, self.device,
                                 paged=shared)
                for _ in range(self.cfg.n_layers)]

    def _head_table(self, params: Params) -> Params:
        """The LM head's table: the embedding's when tied."""
        return params["embed" if self.cfg.tie_embeddings else "unembed"]

    def _head(self, params: Params, x: torch.Tensor,
              last_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, V) at each lane's `last_index` (or the last row).
        The final norm runs over every row before the row is taken (the
        reference takes it first): the norm's device reduction may order
        its sums by how many rows it sees, and over the same rows as in
        `forward` the head's input, and with it the logits, are
        `forward`'s bit for bit."""
        cfg = self.cfg
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(self._head_table(params),
                         self._take_last(x, last_index), cfg,
                         self.eng.for_role("head"))
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
        x, _ = stack_apply(params["layers"], cfg, x, pos, self.eng,
                           caches=cache)
        return self._head(params, x, last_index), cache, None

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
        x, _ = stack_apply(params["layers"], cfg, x, pos, self.eng,
                           caches=cache, chunked=True)
        return self._head(params, x, last_index), cache

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
        x, _ = stack_apply(params["layers"], self.cfg, x, pos[:, None],
                           self.eng, caches=cache)
        return self._head(params, x), cache


def lm_loss(model: Model, params: Params, batch: Dict[str, torch.Tensor],
            *, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: predict tokens[t+1] from tokens[<=t], a masked
    NLL through logsumexp in f32 (batch["mask"] (B, S) optional).
    Returns (loss + aux_weight * aux, {"loss", "aux", "ppl_proxy"})."""
    logits, aux = model.forward(params, batch)
    tokens = batch["tokens"].to(logits.device)
    targets = tokens[:, 1:].to(torch.int64)
    logits = logits[:, :-1]
    mask = batch.get("mask")
    mask = (mask[:, 1:].to(logits.device, torch.float32) if mask is not None
            else torch.ones(targets.shape, dtype=torch.float32,
                            device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
