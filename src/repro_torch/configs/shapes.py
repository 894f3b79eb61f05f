"""Assigned input shapes and the per-arch skip policy.

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one token against a seq_len cache); the others lower
``train_step`` / ``prefill_step``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str             # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM / hybrid /
# windowed archs (see DESIGN.md §Shape/skip policy).
LONG_OK = {"rwkv6-3b", "recurrentgemma-9b", "h2o-danube-3-4b"}


def cells(arch_names):
    """All (arch, shape) cells with skip annotations."""
    out = []
    for a in arch_names:
        for s in SHAPES.values():
            skip = (s.name == "long_500k" and a not in LONG_OK)
            reason = ("full-attention arch: 500k decode is quadratic-cost "
                      "with no windowing in the published config"
                      if skip else "")
            out.append((a, s.name, skip, reason))
    return out
