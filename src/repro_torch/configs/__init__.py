"""Architecture registry: --arch <id> resolution for all assigned configs.

The counterpart of ``repro.configs``: the same ten architectures, each a
``CONFIG`` at its published widths and a ``SMOKE`` of the same family.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "yi-34b": "yi_34b",
    "whisper-base": "whisper_base",
    "grok-1-314b": "grok1_314b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


from .shapes import SHAPES, LONG_OK, cells, ShapeSpec  # noqa: E402

__all__ = ["ARCHS", "get_config", "SHAPES", "LONG_OK", "cells", "ShapeSpec"]
