"""Continuous-batching serving engine of the port, with its degrade
ladder, fault injection and traffic replay."""
from .degrade import DegradeLadder
from .engine import Request, ServeEngine
from .faults import (FaultConfig, FaultInjector, FaultPlan,
                     TransientPrefillError, build_fault_plan)
from .replay import ReplayConfig, build_workload, run_replay, step_report
from .report import ServeReport

__all__ = ["Request", "ServeEngine", "ServeReport", "DegradeLadder",
           "FaultConfig", "FaultInjector", "FaultPlan",
           "TransientPrefillError", "build_fault_plan", "ReplayConfig",
           "build_workload", "run_replay", "step_report"]
