"""The platform core of the port: workflow stage graphs and templates,
intent-based planning over a resource catalog, the roofline cost model,
provenance, budgets and the execution envelope — copies of the
reference package's ``core`` modules, with torch stage bodies, and the
H100 as a card the catalog takes by registration
(:func:`register_card`)."""
from repro_torch.core.budget import BudgetExceeded, BudgetLedger, PermissionDenied, Workspace
from repro_torch.core.calibrate import (
    Calibration,
    CalibrationStore,
    CellCalibration,
    DriftReport,
    Sample,
    check_drift,
    fit_cells,
    harvest_bench,
    harvest_run,
    harvest_runs_dir,
)
from repro_torch.core.calibrate import activate as activate_calibration
from repro_torch.core.calibrate import deactivate as deactivate_calibration
from repro_torch.core.catalog import (
    CARDS,
    CATALOG,
    CHIPS,
    H100,
    CandidateTable,
    SliceType,
    build_catalog,
    candidate_table,
    card_slices,
    catalog_generation,
    catalog_summary,
    find_slice,
    register_card,
    register_slice,
    unregister_card,
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
from repro_torch.core.explore import (
    CellSpec,
    ExploreResult,
    ExploreSpec,
    FrontierPoint,
    compare_markdown,
    explore,
    report_markdown,
    result_doc,
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
from repro_torch.core.check import (
    CODES,
    CheckError,
    CheckReport,
    Diagnostic,
    check_spec,
    check_workflow,
    insert_movement_stages,
)
from repro_torch.core.spec import (
    SPEC_VERSION,
    DeclaredStage,
    SpecError,
    dump_spec,
    dumps_spec,
    from_spec,
    load_spec,
    load_workflow,
    pack_template,
    register_stage_type,
    spec_for_template,
    to_spec,
    unpack_package,
    validate_spec,
)
from repro_torch.core.runqueue import RunQueue, RunQueueClosed, RunTicket
from repro_torch.core.stagecache import RunManifest, StageCache
from repro_torch.core.provenance import (
    ProvenanceStore,
    RunRecord,
    StageRecordView,
    capture_environment,
    stable_hash,
)
from repro_torch.core.registry import (
    PROVIDERS,
    ProviderProfile,
    ProviderRegistry,
    SliceOffer,
)
from repro_torch.core.stages import (
    CHECKS,
    CalibrateStage,
    DataStage,
    EvalStage,
    ExploreStage,
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
    "CARDS", "H100", "card_slices", "register_card", "unregister_card",
    "BatchEstimate", "CostEstimate", "PlanGeometry", "RetryCost",
    "estimate", "estimate_batch", "retry_expected_cost",
    "CellSpec", "ExploreResult", "ExploreSpec", "FrontierPoint",
    "explore", "report_markdown", "result_doc", "compare_markdown",
    "Calibration", "CalibrationStore", "CellCalibration", "DriftReport",
    "Sample", "check_drift", "fit_cells", "harvest_bench", "harvest_run",
    "harvest_runs_dir", "activate_calibration", "deactivate_calibration",
    "PROVIDERS", "ProviderProfile", "ProviderRegistry", "SliceOffer",
    "ExecutionEnvelope", "ResourceIntent",
    "CycleError", "FnStage", "GraphError", "MissingInputError", "Placement",
    "Stage", "StageCache", "StageContext", "StageGraph", "StageResult",
    "RunManifest",
    "EXECUTOR_KINDS", "Executor", "LocalPoolExecutor", "ThreadedExecutor",
    "WorkerQueueExecutor", "make_executor",
    "RunQueue", "RunQueueClosed", "RunTicket",
    "FailureSchedule", "InjectedFailure", "RestartPolicy", "WorkerLost",
    "PlanChoice", "clear_planner_cache", "enumerate_plans", "intent_hash",
    "plan", "plan_stages", "prune_dominated", "rank", "to_runtime_plan",
    "ProvenanceStore", "RunRecord", "StageRecordView",
    "capture_environment", "stable_hash",
    "CHECKS", "CalibrateStage", "DataStage", "EvalStage", "ExploreStage",
    "MoveStage", "PlanStage", "ServeStage", "TrainStage", "ValidateStage",
    "VisualizeStage",
    "REGISTRY", "WorkflowRegistry", "WorkflowResult",
    "WorkflowTemplate", "compile_template", "resolve_placement_map",
    "resolve_placements", "run_workflow",
    "SPEC_VERSION", "SpecError", "DeclaredStage", "register_stage_type",
    "to_spec", "from_spec", "validate_spec", "dumps_spec", "dump_spec",
    "load_spec", "load_workflow", "spec_for_template", "pack_template",
    "unpack_package",
    "CODES", "CheckError", "CheckReport", "Diagnostic", "check_spec",
    "check_workflow", "insert_movement_stages",
]
