from .ops import decode_attention
from .ref import decode_ref

__all__ = ["decode_attention", "decode_ref"]
