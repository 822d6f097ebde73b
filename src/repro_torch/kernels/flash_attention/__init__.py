from .ops import attention
from .ref import mha_ref

__all__ = ["attention", "mha_ref"]
