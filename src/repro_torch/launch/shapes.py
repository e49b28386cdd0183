"""Assigned input-shape cells (the x4 set every LM arch is paired with), as
data: the same cells as :mod:`repro.launch.shapes`."""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeCell", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}
