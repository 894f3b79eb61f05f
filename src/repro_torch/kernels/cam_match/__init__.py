from .ref import cam_scan_ref, cam_search_ref
from .ops import cam_search, scan, search

__all__ = ["cam_search_ref", "cam_scan_ref", "cam_search", "search", "scan"]
