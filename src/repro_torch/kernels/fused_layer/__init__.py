from .ops import (fused_gnn_forward, fused_gnn_forward_batched,
                  fused_gnn_layer, fused_ideal_layer, fused_ideal_layer_plain,
                  fused_quant_layer, fused_quant_layer_plain, fused_zmax,
                  fused_zmax_plain, quant_operands)
from .ref import fused_layer_ref

__all__ = [
    "fused_ideal_layer", "fused_ideal_layer_plain", "fused_quant_layer",
    "fused_quant_layer_plain", "fused_zmax", "fused_zmax_plain",
    "fused_gnn_layer", "fused_gnn_forward", "fused_gnn_forward_batched",
    "quant_operands", "fused_layer_ref",
]
