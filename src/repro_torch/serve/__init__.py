from .engine import ServeEngine, ServeStats
from .faults import FaultPlan

__all__ = ["FaultPlan", "ServeEngine", "ServeStats"]
