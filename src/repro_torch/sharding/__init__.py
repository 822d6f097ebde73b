"""Sharding: the logical-axis rules (``rules``), their per-dim resolution
(``spec``) and the context and collectives the model code runs under
(``ctx``); the JAX package's ``sharding/`` over ``torch.distributed``."""
from . import ctx, rules, spec
from .rules import (array_sharding, batch_shardings, data_axes, ep_degree,
                    make_rules, named)

__all__ = ["array_sharding", "batch_shardings", "ctx", "data_axes",
           "ep_degree", "make_rules", "named", "rules", "spec"]
