"""Optimizer and gradient compression, the counterpart of ``repro.optim``.

``compressed_psum`` (the reference's int8 all-reduce over a mesh axis) is
not exported yet: it needs a process group and lands with the multi-card
runtime.
"""
from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .compress import int8_compress, int8_decompress

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "int8_compress", "int8_decompress"]
