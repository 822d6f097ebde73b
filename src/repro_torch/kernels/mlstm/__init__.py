from .ops import mlstm
from .ref import (mlstm_chunkwise_xla, mlstm_final_state,
                  mlstm_parallel_ref, mlstm_step)

__all__ = ["mlstm", "mlstm_chunkwise_xla", "mlstm_final_state",
           "mlstm_parallel_ref", "mlstm_step"]
