"""The yardstick: the card's published peaks and the work a step needs.

Copied here so that a change to the program cannot move it.

``H100`` is NVIDIA's H100 SXM data sheet (dense rates, no sparsity) at
its full 700 W power limit: 989.4 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s of HBM3, 80 GB. A run
reports the card's own power limit beside the numbers.

The work is counted from the shapes alone, never from what an
implementation happens to run:
  * ``train_flops``: 6 N D, N the parameters of the reference's
    ``param_specs`` and D the tokens of a step (the count of the
    program's ``analysis/roofline.model_flops``, with N counted from the
    parameters themselves);
  * ``adamw_bytes``: each parameter, gradient and moment read once, each
    parameter and moment written once, in the dtypes the step holds them
    (the gradient in its parameter's dtype, the moments float32): 22 B a
    bf16 parameter, 28 B a float32 one.
"""
from __future__ import annotations

import math

H100 = {"bf16_flops": 989.4e12, "f32_flops": 67e12, "hbm_bps": 3.35e12,
        "hbm_bytes": 80e9, "power_w": 700.0}

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def param_count(specs: dict) -> int:
    return sum(math.prod(shape) for shape, _, _ in specs.values())


def train_flops(specs: dict, tokens: int) -> float:
    """Model FLOPs of one training step over ``tokens`` tokens."""
    return 6.0 * param_count(specs) * tokens


def adamw_bytes(specs: dict) -> int:
    """Bytes one AdamW update must move at the least."""
    return sum(math.prod(shape) * (3 * _ITEMSIZE[dtype] + 16)
               for shape, dtype, _ in specs.values())

