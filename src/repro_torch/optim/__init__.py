"""Optimizer and gradient compression, the counterpart of ``repro.optim``."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, reset_update_paths, update_paths)
from .compress import compressed_psum, int8_compress, int8_decompress

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compressed_psum", "int8_compress",
           "int8_decompress", "reset_update_paths", "update_paths"]
