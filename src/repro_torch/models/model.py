"""Model facade of every ported family (port of `repro/models/model.py`):

  init(seed, keep=)                            -> params
  forward(params, batch, part=)                -> (logits (B, S, V), aux)
  init_cache(batch, max_len, paged=)           -> per-layer caches
  prefill(params, batch, cache, last_index=, part=)
                                               -> (last logits, cache, memory)
  prefill_chunk(params, batch, cache, start, last_index=)
                                               -> (logits, cache)
  decode_step(params, token, pos, cache, memory=, part=)
                                               -> (logits, cache)

`batch` holds tokens (B, S) and, per family, the stub frontend's
embeddings (B, M, d_model): "frames" (encdec), run through the non-causal
encoder into the memory the cross-attention layers read, or "patches"
(vlm), the memory as they are. `prefill` returns the memory so the decode
steps that follow can be handed it; other families get None.

The model lives on one device, the CUDA card unless the caller passes
device="cpu". Weights are drawn from a seeded torch.Generator on that
device (jax.random's numbers cannot be reproduced; `convert.py` carries a
JAX parameter tree over instead). `lm_loss` is the causal LM loss over
`forward`.

`forward`, `lm_loss`, `prefill` and `decode_step` take an optional
partition context `part` (`distributed/partition.py`): the params and
cache are then this rank's blocks at the Sharder's specs, the batch and
the memory this rank's rows (the memory whole over `model`), and the
logits this rank's vocab columns (the partitioned steps of
`distributed/train.py`; `forward` and `lm_loss` under gradients). `init(keep=)` hands
each leaf, as it is drawn, to `keep`, which returns what the tree holds:
this rank's block, say, so that no whole model exists on a rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import Keep, _whole, embed, embedding_init, rmsnorm, unembed
from .transformer import _under, block_cache_init, block_init, stack_apply

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

    def init(self, seed: int = 0, keep: Optional[Keep] = None) -> Params:
        """Every leaf drawn from one generator in a fixed order. `keep(path,
        leaf)` (a path of `sharding.path_leaves`, "layers/3/attn/wq")
        takes each leaf as it is made and returns what the tree holds; an
        embedding table's and a dense layer's leaves reach it one by one,
        before the next draw. The draws do not depend on it."""
        cfg, dev = self.cfg, self.device
        keep = keep or _whole
        # device="meta" gives the shapes and dtypes alone (nothing drawn)
        gen = None if dev.type == "meta" else torch.Generator(
            device=dev).manual_seed(seed)

        def table(name):
            return {"table": keep(f"{name}/table",
                                  embedding_init(gen, cfg, dev)["table"])}

        params: Params = {
            "embed": table("embed"),
            "layers": [block_init(gen, cfg, kind, dev,
                                  _under(keep, f"layers/{i}"))
                       for i, kind in enumerate(cfg.layer_kinds)],
            "final_norm": {"scale": keep("final_norm/scale", torch.ones(
                (cfg.d_model,), dtype=cfg.pdtype, device=dev))},
        }
        if not cfg.tie_embeddings:
            params["unembed"] = table("unembed")
        if cfg.n_enc_layers:
            enc = self._encoder_cfg()
            params["encoder"] = {
                "layers": [block_init(gen, enc, kind, dev,
                                      _under(keep, f"encoder/layers/{i}"))
                           for i, kind in enumerate(enc.layer_kinds)],
                "final_norm": {"scale": keep("encoder/final_norm/scale",
                                             torch.ones((cfg.d_model,),
                                                        dtype=cfg.pdtype,
                                                        device=dev))}}
        return params

    def _encoder_cfg(self) -> ModelConfig:
        """The encoder's config: n_enc_layers plain attention layers with a
        GELU MLP, no experts and no window."""
        return dataclasses.replace(
            self.cfg, block_pattern=("attn",), n_layers=self.cfg.n_enc_layers,
            n_experts=0, experts_per_token=0, sliding_window=None,
            mlp_type="gelu")

    def _memory(self, params: Params, batch: Dict[str, torch.Tensor],
                part=None) -> Optional[torch.Tensor]:
        """What the cross-attention layers attend to: an encdec model's
        frames through the non-causal encoder and its final norm, a vlm
        model's patches as they are, in the compute dtype; None for the
        other families. Under a partition context the encoder runs on
        this rank's blocks (its final norm is replicated) and the memory
        is this rank's rows of it, whole over `model`."""
        cfg = self.cfg
        if cfg.family == "encdec":
            frames = batch["frames"].to(self.device, cfg.cdtype)
            B, M = frames.shape[:2]
            pos = torch.arange(M, device=self.device)[None].expand(B, M)
            enc = params["encoder"]
            h, _ = stack_apply(enc["layers"], self._encoder_cfg(), frames,
                               pos, self.eng, causal=False, part=part)
            return rmsnorm(enc["final_norm"], h, cfg.norm_eps)
        if cfg.family == "vlm":
            return batch["patches"].to(self.device, cfg.cdtype)
        return None

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                part=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of tokens (B, S): (f32 logits (B, S,
        vocab_padded), aux loss). Not under no_grad, so a training step
        can take gradients through it. Under a partition context `part`
        the params are this rank's blocks, the batch its rows, and the
        logits its vocab columns (B, S, vocab_padded / model)."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        memory = self._memory(params, batch, part)
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = embed(params["embed"], tokens, cfg, part)
        x, aux = stack_apply(params["layers"], cfg, x, pos, self.eng,
                             memory=memory, part=part)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(self._head_table(params), x, cfg,
                         self.eng.for_role("head"), part)
        return logits.to(torch.float32), aux

    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[Dict[str, int]] = None) -> List[Params]:
        """One cache per layer, in execution order. paged={"num_blocks":
        NB, "block_size": bs} gives every self-attention layer without a
        sliding window a block-pool KV layout with one (batch,
        ceil(max_len/bs)) block table shared by those layers (all entries
        start at the trash block), and only where such a layer exists;
        window layers keep their contiguous rings and recurrent layers
        their per-lane states. The default is the contiguous per-lane
        layout."""
        cfg = self.cfg
        shared = None
        if (paged is not None and cfg.sliding_window is None
                and {"attn", "xdec"} & set(cfg.layer_kinds)):
            mbl = -(-max_len // paged["block_size"])
            shared = {**paged, "table": torch.zeros(
                (batch, mbl), dtype=torch.int32, device=self.device)}
        return [block_cache_init(cfg, kind, batch, max_len, self.device,
                                 paged=shared)
                for kind in cfg.layer_kinds]

    def _head_table(self, params: Params) -> Params:
        """The LM head's table: the embedding's when tied."""
        return params["embed" if self.cfg.tie_embeddings else "unembed"]

    def _head(self, params: Params, x: torch.Tensor,
              last_index: Optional[torch.Tensor] = None, part=None
              ) -> torch.Tensor:
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
                         self.eng.for_role("head"), part)
        return logits[:, 0].to(torch.float32)

    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache: List[Params], last_index: Optional[torch.Tensor] = None,
                part=None
                ) -> Tuple[torch.Tensor, List[Params], Optional[torch.Tensor]]:
        """Process prompts (B, S); returns (logits at each lane's
        `last_index` (or S-1), cache, the memory the decode steps attend
        to, None without a frontend). Right-padded prompts are safe
        for attention layers (causal attention masks the padding, and
        later decode steps overwrite its cache slots position for
        position), not for recurrent ones, whose state advances over the
        padding: the serving engine prefills those at exact length."""
        cfg = self.cfg
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        memory = self._memory(params, batch, part)
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        x = embed(params["embed"], tokens, cfg, part)
        x, _ = stack_apply(params["layers"], cfg, x, pos, self.eng,
                           caches=cache, memory=memory, part=part)
        return self._head(params, x, last_index, part), cache, memory

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
                    pos: torch.Tensor, cache: List[Params],
                    memory: Optional[torch.Tensor] = None, part=None
                    ) -> Tuple[torch.Tensor, List[Params]]:
        """token (B,), pos (B,) absolute position of `token`; `memory` is
        what prefill returned (enc-dec and VLM models)."""
        token = token.to(self.device)
        pos = pos.to(self.device)
        x = embed(params["embed"], token[:, None], self.cfg, part)
        x, _ = stack_apply(params["layers"], self.cfg, x, pos[:, None],
                           self.eng, caches=cache, memory=memory, part=part)
        return self._head(params, x, part=part), cache


def lm_loss(model: Model, params: Params, batch: Dict[str, torch.Tensor],
            *, aux_weight: float = 0.01, part=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss: predict tokens[t+1] from tokens[<=t], a masked
    NLL through logsumexp in f32 (batch["mask"] (B, S) optional).
    Returns (loss + aux_weight * aux, {"loss", "aux", "ppl_proxy"}).

    Under a partition context `part` (`Model.forward`'s) the batch is this
    rank's rows and the logsumexp runs over the vocab columns of every
    rank along `model`, padded ones too, as the reference's sees them: the
    row's largest logit taken over `model` (detached), the sum of the
    exponentials summed over `model`, the gold logit taken on the rank
    that holds its column and summed. The loss is the same on every rank
    along `model`."""
    logits, aux = model.forward(params, batch, part)
    tokens = batch["tokens"].to(logits.device)
    targets = tokens[:, 1:].to(torch.int64)
    logits = logits[:, :-1]
    mask = batch.get("mask")
    mask = (mask[:, 1:].to(logits.device, torch.float32) if mask is not None
            else torch.ones(targets.shape, dtype=torch.float32,
                            device=logits.device))
    if part is not None and part.size > 1:
        logz, gold = _vocab_parallel(logits, targets, part)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


def _vocab_parallel(logits: torch.Tensor, targets: torch.Tensor, part
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, the gold logit) of every row, from this rank's vocab
    columns of the logits (B, S, V / model), over `model`."""
    m = part.max(logits.detach().amax(dim=-1))
    cols = logits.shape[-1]
    ids = targets - part.rank * cols
    mine = (ids >= 0) & (ids < cols)
    gold = torch.gather(logits, -1, ids.clamp(0, cols - 1)[..., None])[..., 0]
    both = part.sum(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(mine, gold, torch.zeros_like(gold))]))
    return torch.log(both[0]) + m, both[1]
