"""Fault tolerance of the port: a copy of the reference's
``ft/failures.py`` (pure Python).  ``FailureSchedule`` injects
deterministic step- and stage-level failures for drills;
``RestartPolicy`` bounds retries with capped exponential backoff and
jitter (read by the execution envelope's step restarts and the stage
graph's per-stage retry); ``StragglerWatch`` flags slow steps into
provenance.  The reference's elastic module (resharding a checkpointed
state onto a re-planned mesh) waits for ROADMAP's "parallelism and
elasticity" entry: one card has no mesh to reshard onto."""
from repro_torch.ft.failures import (
    FailureSchedule,
    InjectedFailure,
    RestartPolicy,
    StragglerWatch,
    WorkerLost,
    run_with_restarts,
)

__all__ = [
    "FailureSchedule",
    "InjectedFailure",
    "RestartPolicy",
    "StragglerWatch",
    "WorkerLost",
    "run_with_restarts",
]
