"""The assigned input-shape sets and their stand-ins (port of
`repro/launch/shapes.py`).

LM transformer shapes are seq_len x global_batch. decode_* / long_* are
serve steps (one new token against a seq_len cache), not train steps.
long_500k needs sub-quadratic attention: it runs for the SSM and hybrid
archs and for sliding-window ones, and is skipped for pure
full-attention archs. The autotuner's CLI derives its launch GEMMs from
these cases, the dry run (`launch/dryrun.py`) walks each of them.

A stand-in is a tensor on the `meta` device: a shape and a dtype, nothing
allocated (the reference's `jax.ShapeDtypeStruct`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCase", "applicable", "input_specs", "cells_for",
           "case_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}

# archs with bounded attention state (SWA window / recurrent) run long_500k
LONG_OK_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(whether the shape case runs for cfg, the reason when it does not)."""
    case = SHAPES[shape]
    if case.name == "long_500k":
        if cfg.family in LONG_OK_FAMILIES or cfg.sliding_window is not None:
            return True, ""
        return False, ("full quadratic attention: 500k decode infeasible "
                       "(skip noted in DESIGN.md)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def case_specs(cfg: ModelConfig, case: ShapeCase) -> Dict[str, Any]:
    """`input_specs` for any ShapeCase, one of SHAPES or not."""
    B, S = case.global_batch, case.seq_len
    out: Dict[str, Any] = {"case": case}
    frontend = (B, cfg.n_frontend_tokens, cfg.d_model)
    if case.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta(frontend, torch.float32)
        if cfg.family == "vlm":
            batch["patches"] = _meta(frontend, torch.float32)
        out["batch"] = batch
    else:
        out["token"] = _meta((B,), torch.int32)
        out["pos"] = _meta((B,), torch.int32)
        if cfg.family in ("encdec", "vlm"):
            out["memory"] = _meta(frontend, cfg.cdtype)
    return out


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this cell.

    train:   {tokens (B,S)}                        -> train_step batch
    prefill: {tokens (B,S)}                        -> prefill batch
    decode:  {token (B,), pos (B,)}                -> decode_step inputs
    plus frontend stubs for encdec (frames) / vlm (patches), and the
    decode memory of both in the compute dtype.
    """
    return case_specs(cfg, SHAPES[shape])


def cells_for(cfg: ModelConfig) -> List[Tuple[str, bool, str]]:
    """(shape name, whether it runs, the reason when it does not) for every
    shape of SHAPES."""
    return [(name, *applicable(cfg, name)) for name in SHAPES]
