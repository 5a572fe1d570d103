"""The assigned input-shape sets (port of `repro/launch/shapes.py`'s
`ShapeCase`, `SHAPES` and `applicable`).

LM transformer shapes are seq_len x global_batch. decode_* / long_* are
serve steps (one new token against a seq_len cache), not train steps.
long_500k needs sub-quadratic attention: it runs for the SSM and hybrid
archs and for sliding-window ones, and is skipped for pure
full-attention archs. The autotuner's CLI derives its launch GEMMs from
these cases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCase", "applicable"]


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
