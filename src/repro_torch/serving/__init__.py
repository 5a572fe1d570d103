"""Continuous-batching serving engine of the port."""
from .engine import Request, ServeEngine
from .report import ServeReport

__all__ = ["Request", "ServeEngine", "ServeReport"]
