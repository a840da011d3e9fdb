"""Fault-tolerant supervision of the secure protocol drivers.

``managers`` holds the simulated control plane (clock, heartbeats,
straggler rule, chaos schedule, remesh plan); ``supervisor`` turns a
schedule of institution and center faults into waits, retries, degraded
reveals and re-provisioning around ``StudyCoordinator``,
``SecureFitDriver`` and ``SelectionCoordinator``.  Pure Python, as in the
JAX package: nothing here imports torch.
"""
from .managers import (
    EVENT_KINDS,
    FailureInjector,
    HeartbeatMonitor,
    RemeshPlan,
    SimClock,
    StragglerPolicy,
    plan_remesh,
)
from .supervisor import FaultPolicy, RoundSupervisor, SupervisedRound

__all__ = [
    "EVENT_KINDS",
    "FailureInjector",
    "FaultPolicy",
    "HeartbeatMonitor",
    "RemeshPlan",
    "RoundSupervisor",
    "SimClock",
    "StragglerPolicy",
    "SupervisedRound",
    "plan_remesh",
]
