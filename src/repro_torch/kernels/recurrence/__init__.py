from .ref import (rglru_scan_backward_ref, rglru_scan_ref,
                  wkv6_scan_backward_ref, wkv6_scan_ref)
from .ops import CHUNK, rglru_scan, wkv6_scan

__all__ = ["rglru_scan_ref", "rglru_scan_backward_ref", "wkv6_scan_ref",
           "wkv6_scan_backward_ref", "CHUNK", "rglru_scan", "wkv6_scan"]
