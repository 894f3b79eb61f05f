"""Device resolution for every entry point of the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``. A
CUDA request on a host without CUDA raises: the port never drops to the
CPU on its own. Callers that want the host (the tests, a laptop) pass
``device="cpu"``, which runs the plain PyTorch version of every kernel.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there
    is no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions on the host")
    return dev
