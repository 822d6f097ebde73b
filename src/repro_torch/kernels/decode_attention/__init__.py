from .ops import decode_attention, decode_combine, decode_split
from .ref import decode_ref

__all__ = ["decode_attention", "decode_combine", "decode_split",
           "decode_ref"]
