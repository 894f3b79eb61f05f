from .ref import (CrossbarNumerics, apply_conductance_noise,
                  crossbar_matmul_ref, crossbar_matmul_signed_ref,
                  quantize_inputs, quantize_weights)

__all__ = [
    "CrossbarNumerics", "apply_conductance_noise", "crossbar_matmul_ref",
    "crossbar_matmul_signed_ref", "quantize_inputs", "quantize_weights",
]
