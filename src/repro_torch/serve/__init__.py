from .engine import ServeEngine, ServeStats
from .faults import FaultPlan
from .scheduler import (
    STOP,
    Completion,
    Request,
    ServeLoopReport,
    SlotScheduler,
    TokenDelta,
    run_serve_loop,
)

__all__ = [
    "Completion",
    "FaultPlan",
    "Request",
    "STOP",
    "ServeEngine",
    "ServeLoopReport",
    "ServeStats",
    "SlotScheduler",
    "TokenDelta",
    "run_serve_loop",
]
