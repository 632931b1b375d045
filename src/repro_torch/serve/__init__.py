from .engine import FleetReport, ServeEngine, ServeStats
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
from .traffic import TrafficReport, run_traffic

__all__ = [
    "Completion",
    "FaultPlan",
    "FleetReport",
    "Request",
    "STOP",
    "ServeEngine",
    "ServeLoopReport",
    "ServeStats",
    "SlotScheduler",
    "TokenDelta",
    "TrafficReport",
    "run_serve_loop",
    "run_traffic",
]
