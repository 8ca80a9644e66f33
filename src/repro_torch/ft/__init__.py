"""Fault tolerance of the port: a copy of the reference's
``ft/failures.py`` (pure Python) and the port of its ``ft/elastic.py``.
``FailureSchedule`` injects deterministic step- and stage-level failures
for drills; ``RestartPolicy`` bounds retries with capped exponential
backoff and jitter (read by the execution envelope's step restarts and
the stage graph's per-stage retry); ``StragglerWatch`` flags slow steps
into provenance.  ``state_shardings``, ``reshard_state`` and
``elastic_restart`` restore a checkpointed train state onto a re-planned
mesh of another size, each rank keeping its block of each leaf."""
from repro_torch.ft.elastic import (elastic_restart, reshard_state,
                                    state_shardings)
from repro_torch.ft.failures import (
    FailureSchedule,
    InjectedFailure,
    RestartPolicy,
    StragglerWatch,
    WorkerLost,
    run_with_restarts,
)

__all__ = [
    "elastic_restart",
    "reshard_state",
    "state_shardings",
    "FailureSchedule",
    "InjectedFailure",
    "RestartPolicy",
    "StragglerWatch",
    "WorkerLost",
    "run_with_restarts",
]
