"""Training-side fault tolerance. Only ``failure`` (straggler detection
and island failover) is ported; the optimizer, checkpoints, compression
and the training step are not."""
from . import failure

__all__ = ["failure"]
