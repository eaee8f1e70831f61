"""Fault-tolerance runtime of the port: heartbeats / straggler detection,
elastic re-mesh planning, and the restart supervisor."""
from repro_torch.runtime.elastic import plan_mesh
from repro_torch.runtime.heartbeat import StepMonitor
from repro_torch.runtime.supervisor import run_with_restarts

__all__ = ["StepMonitor", "plan_mesh", "run_with_restarts"]
