"""The four assigned input shapes (LM transformer pool).

``train_*`` lower ``train_step``; ``prefill_*`` lower the prefill;
``decode_*``/``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len).  ``long_500k`` requires sub-quadratic attention: run for
SSM/hybrid/linear-attention (+ sliding-window) archs, skip for pure
full-attention archs (``registry.cell_is_skipped``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
