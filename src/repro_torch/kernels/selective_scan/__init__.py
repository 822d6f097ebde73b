from .ops import selective_scan
from .ref import selective_scan_chunked, selective_scan_ref, selective_step

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_chunked",
           "selective_step"]
