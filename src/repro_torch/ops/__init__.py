"""Operational scenarios of the PyTorch port (mirrors :mod:`repro.ops`):
dynamic capacity, failure/retry injection, model-lifecycle compilation,
and cost/SLO accounting for both engines (see each submodule)."""
from repro_torch.ops.accounting import (SLOConfig, busy_node_seconds,
                                        capacity_cost, lifecycle_summary,
                                        pipeline_spans, realized_schedule,
                                        scenario_summary, slo_metrics)
from repro_torch.ops.capacity import (CapacitySchedule, MaintenanceWindows,
                                      ReactiveAutoscaler, ReactiveController,
                                      ScheduledAutoscaler, StaticCapacity,
                                      apply_capacity_deltas,
                                      disabled_controller, normalize,
                                      static_schedule)
from repro_torch.ops.failures import FailureModel, OutageModel, RetryPolicy
from repro_torch.ops.scenario import (CompiledFleet, CompiledScenario,
                                      Scenario, compile_fleet, compile_static,
                                      stack_compiled_scenarios)

__all__ = [
    "CapacitySchedule", "StaticCapacity", "MaintenanceWindows",
    "ScheduledAutoscaler", "ReactiveAutoscaler", "ReactiveController",
    "static_schedule", "normalize", "apply_capacity_deltas",
    "disabled_controller",
    "FailureModel", "OutageModel", "RetryPolicy",
    "SLOConfig", "busy_node_seconds", "capacity_cost", "pipeline_spans",
    "realized_schedule", "scenario_summary", "slo_metrics",
    "lifecycle_summary",
    "Scenario", "CompiledScenario", "compile_static",
    "CompiledFleet", "compile_fleet",
    "stack_compiled_scenarios",
]
