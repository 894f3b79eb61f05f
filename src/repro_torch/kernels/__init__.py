"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel module has ``ref.py`` (plain PyTorch) and ``ops.py`` (the
wrapper that launches the CUDA kernel from ``repro_torch/csrc`` on a CUDA
tensor and runs the plain version on a CPU tensor; ``recurrence`` registers
its two scans as custom ops with a backward kernel each; ``attention`` binds
its forward and backward kernels to autograd; ``optim`` updates a tree's
leaves in place). ``launch_counts`` reads the
wrappers' launch counters and ``reset_launch_counts`` sets them to 0.
"""
from __future__ import annotations


def _wrappers() -> dict:
    from .cam_match.ops import cam_search
    from .crossbar_mvm.ops import crossbar_matmul_quantized
    from .csr_aggregate.ops import csr_aggregate
    from .fused_layer.ops import fused_ideal_layer, fused_quant_layer, fused_zmax
    from .recurrence.ops import rglru_scan, wkv6_scan
    from .attention.ops import (flash_attention_backward,
                                flash_attention_forward)
    from .optim.ops import adamw_norm, adamw_update
    return {f.__name__: f for f in (fused_ideal_layer, fused_zmax,
                                    fused_quant_layer, csr_aggregate,
                                    crossbar_matmul_quantized, cam_search,
                                    rglru_scan, wkv6_scan,
                                    flash_attention_forward,
                                    flash_attention_backward, adamw_norm,
                                    adamw_update)}


def launch_counts() -> dict:
    """``{kernel name: launches}`` of the twelve kernel wrappers: the six
    that replace the reference's Pallas kernels, the two sequence scans
    (forward and backward launches both), flash attention's forward
    and backward (two launches a backward call: the dQ and dK/dV
    passes) and AdamW's norm (two launches a call up to ``MAX_LEAVES``
    leaves: the partial sums and their sum) and update (one a dtype
    pair)."""
    return {name: f.launches for name, f in _wrappers().items()}


def reset_launch_counts() -> None:
    for f in _wrappers().values():
        f.launches = 0
