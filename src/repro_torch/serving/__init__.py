"""The port's serving path: the continuous-batching ``Engine`` over a
``repro_torch.models`` LM, the per-stream schedulers, the engine-rung
planes (the DES ``measure_engine_epoch`` and the tick scan), the
``AnalyticsService`` with its GI/G/1 data plane, and scenario replay."""
from .engine import Engine, NullAnalyticsModel, Result, make_replay_engine
from .engine_plane import measure_engine_epoch
from .replay import (ReplayResult, ScenarioReplay, TableSystem,
                     make_controller, replay_suite, replay_tables)
from .scheduler import (FCFS, LCFSP, AoPITracker, Frame, StreamQueue,
                        StreamTelemetry)
from .service import (AnalyticsService, EpochReport, measure_mm1,
                      measure_mm1_loop, measure_window)
from .tick_plane import (ENGINE_BACKENDS, measure_engine_epoch_scan,
                         measure_engine_window_scan, measure_epoch,
                         resolve_engine_backend)

__all__ = ["Engine", "NullAnalyticsModel", "Result", "make_replay_engine",
           "measure_engine_epoch", "FCFS", "LCFSP", "AoPITracker", "Frame",
           "StreamQueue", "StreamTelemetry", "AnalyticsService",
           "EpochReport", "measure_mm1", "measure_mm1_loop",
           "measure_window", "ReplayResult", "ScenarioReplay",
           "TableSystem", "make_controller", "replay_suite",
           "replay_tables", "ENGINE_BACKENDS", "measure_engine_epoch_scan",
           "measure_engine_window_scan", "measure_epoch",
           "resolve_engine_backend"]
