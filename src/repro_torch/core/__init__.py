"""The platform core of the port: workflow stage graphs and templates,
intent-based planning over a resource catalog, the roofline cost model,
provenance, budgets and the execution envelope — copies of the
reference package's ``core`` modules, with torch stage bodies.

The explore, check, spec and run-queue modules, the provider registry
and the calibrate and explore stages wait for ROADMAP queue 1, the
control plane."""
from repro_torch.core.budget import BudgetExceeded, BudgetLedger, PermissionDenied, Workspace
from repro_torch.core.calibrate import (
    Calibration,
    CalibrationStore,
    CellCalibration,
    DriftReport,
    Sample,
    check_drift,
    fit_cells,
)
from repro_torch.core.calibrate import activate as activate_calibration
from repro_torch.core.calibrate import deactivate as deactivate_calibration
from repro_torch.core.catalog import (
    CATALOG,
    CHIPS,
    CandidateTable,
    SliceType,
    build_catalog,
    candidate_table,
    catalog_generation,
    catalog_summary,
    find_slice,
    register_slice,
    unregister_slice,
)
from repro_torch.core.costmodel import (
    BatchEstimate,
    CostEstimate,
    PlanGeometry,
    RetryCost,
    estimate,
    estimate_batch,
    retry_expected_cost,
)
from repro_torch.core.envelope import ExecutionEnvelope
from repro_torch.core.executor import (
    EXECUTOR_KINDS,
    Executor,
    LocalPoolExecutor,
    ThreadedExecutor,
    WorkerQueueExecutor,
    make_executor,
)
from repro_torch.core.graph import (
    CycleError,
    FnStage,
    GraphError,
    MissingInputError,
    Placement,
    Stage,
    StageContext,
    StageGraph,
    StageResult,
)
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.planner import (
    PlanChoice,
    clear_planner_cache,
    enumerate_plans,
    intent_hash,
    plan,
    plan_stages,
    prune_dominated,
    rank,
    to_runtime_plan,
)
from repro_torch.core.stagecache import RunManifest, StageCache
from repro_torch.core.provenance import (
    ProvenanceStore,
    RunRecord,
    StageRecordView,
    capture_environment,
    stable_hash,
)
from repro_torch.core.stages import (
    CHECKS,
    DataStage,
    EvalStage,
    MoveStage,
    PlanStage,
    ServeStage,
    TrainStage,
    ValidateStage,
    VisualizeStage,
)
from repro_torch.core.workflow import (
    REGISTRY,
    WorkflowRegistry,
    WorkflowResult,
    WorkflowTemplate,
    compile_template,
    resolve_placement_map,
    resolve_placements,
    run_workflow,
)
from repro_torch.ft.failures import (
    FailureSchedule,
    InjectedFailure,
    RestartPolicy,
    WorkerLost,
)

__all__ = [
    "BudgetExceeded", "BudgetLedger", "PermissionDenied", "Workspace",
    "CATALOG", "CHIPS", "CandidateTable", "SliceType", "build_catalog",
    "candidate_table", "catalog_generation", "catalog_summary",
    "find_slice", "register_slice", "unregister_slice",
    "BatchEstimate", "CostEstimate", "PlanGeometry", "RetryCost",
    "estimate", "estimate_batch", "retry_expected_cost",
    "Calibration", "CalibrationStore", "CellCalibration", "DriftReport",
    "Sample", "check_drift", "fit_cells",
    "activate_calibration", "deactivate_calibration",
    "ExecutionEnvelope", "ResourceIntent",
    "CycleError", "FnStage", "GraphError", "MissingInputError", "Placement",
    "Stage", "StageCache", "StageContext", "StageGraph", "StageResult",
    "RunManifest",
    "EXECUTOR_KINDS", "Executor", "LocalPoolExecutor", "ThreadedExecutor",
    "WorkerQueueExecutor", "make_executor",
    "FailureSchedule", "InjectedFailure", "RestartPolicy", "WorkerLost",
    "PlanChoice", "clear_planner_cache", "enumerate_plans", "intent_hash",
    "plan", "plan_stages", "prune_dominated", "rank", "to_runtime_plan",
    "ProvenanceStore", "RunRecord", "StageRecordView",
    "capture_environment", "stable_hash",
    "CHECKS", "DataStage", "EvalStage", "MoveStage", "PlanStage",
    "ServeStage", "TrainStage", "ValidateStage", "VisualizeStage",
    "REGISTRY", "WorkflowRegistry", "WorkflowResult",
    "WorkflowTemplate", "compile_template", "resolve_placement_map",
    "resolve_placements", "run_workflow",
]
