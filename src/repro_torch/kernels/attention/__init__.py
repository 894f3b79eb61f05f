from .ref import (flash_attention_backward_ref, flash_attention_forward_ref,
                  split3)
from .ops import (HEAD_DIM, flash_attention, flash_attention_backward,
                  flash_attention_forward)

__all__ = ["flash_attention_forward_ref", "flash_attention_backward_ref",
           "split3", "HEAD_DIM", "flash_attention",
           "flash_attention_backward", "flash_attention_forward"]
