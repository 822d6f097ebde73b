"""The port's serving path: the continuous-batching ``Engine`` over a
``repro_torch.models`` LM, the per-stream schedulers, and the engine-rung
measurement plane (``measure_engine_epoch``). ``AnalyticsService``, the
tick-scan plane and replay wait for ROADMAP queue 1 item 8."""
from .engine import Engine, NullAnalyticsModel, Result, make_replay_engine
from .engine_plane import measure_engine_epoch
from .scheduler import FCFS, LCFSP, AoPITracker, Frame, StreamQueue

__all__ = ["Engine", "NullAnalyticsModel", "Result", "make_replay_engine",
           "measure_engine_epoch", "FCFS", "LCFSP", "AoPITracker", "Frame",
           "StreamQueue"]
