"""Training: AdamW (``optimizer``), the train and eval steps with
microbatch accumulation (``train_step``), atomic checkpoints
(``checkpoint``), int8 gradient compression (``compression``), and
straggler detection and island failover (``failure``)."""
from . import checkpoint, compression, failure, optimizer, train_step
from .optimizer import AdamWConfig
from .train_step import make_eval_step, make_train_step

__all__ = ["checkpoint", "compression", "failure", "optimizer",
           "train_step", "AdamWConfig", "make_eval_step", "make_train_step"]
