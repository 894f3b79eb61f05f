from .ref import adamw_leaf, clip_scale, clipped
from .ops import MAX_LEAVES, adamw_norm, adamw_update

__all__ = ["adamw_leaf", "clip_scale", "clipped", "MAX_LEAVES", "adamw_norm",
           "adamw_update"]
