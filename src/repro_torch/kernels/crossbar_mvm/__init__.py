from .ref import (CrossbarNumerics, apply_conductance_noise,
                  crossbar_matmul_quantized_plain, crossbar_matmul_ref,
                  crossbar_matmul_signed_ref, quantize_inputs,
                  quantize_weights)
from .ops import (Conductances, crossbar_matmul, crossbar_matmul_programmed,
                  crossbar_matmul_quantized, crossbar_matmul_signed,
                  program_conductances)

__all__ = [
    "CrossbarNumerics", "apply_conductance_noise", "crossbar_matmul_ref",
    "crossbar_matmul_signed_ref", "quantize_inputs", "quantize_weights",
    "crossbar_matmul_quantized_plain", "crossbar_matmul_quantized",
    "crossbar_matmul_programmed", "crossbar_matmul", "crossbar_matmul_signed",
    "Conductances", "program_conductances",
]
