"""Fault tolerance: failure injection, restart policy, straggler watch.

A copy of the reference package's ``ft/failures.py`` (pure Python).

The paper's §6 names "durability for long-running jobs" as future work —
we implement it.  The model here is the standard multi-controller TPU one:
a node failure kills the step; recovery = re-provision (possibly at a
different scale) + restore newest committed checkpoint + replay the data
stream from the restored step (exact, because the pipeline is a pure
function of step).

Two failure granularities are injectable for drills and tests:

  * **step-level** (``FailureSchedule.check(step)``): the train loop dies
    mid-run and the :class:`~repro_torch.core.envelope.ExecutionEnvelope`
    restores from the newest committed checkpoint;
  * **stage-level** (``FailureSchedule.check_stage(name)``): a whole
    workflow stage dies and the :class:`~repro_torch.core.graph.StageGraph`
    scheduler retries it under its :class:`RestartPolicy`, emitting
    ``stage_failed`` / ``stage_retry`` provenance events.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Mapping, Optional, Tuple


class InjectedFailure(RuntimeError):
    """A simulated node/step/stage failure."""


class WorkerLost(RuntimeError):
    """An executor worker died (or went silent past its lease) while
    running a stage body.

    Raised by :mod:`repro_torch.core.executor` backends — a broken
    process-pool child, or a worker-queue lease revoked more than
    ``max_requeues`` times.  It is a *resource* failure, not a bug in
    the stage, so it is retryable under the default
    :class:`RestartPolicy` exactly like :class:`InjectedFailure`.
    """


@dataclasses.dataclass
class FailureSchedule:
    """Deterministic failure injection for tests/drills.

    ``fail_at_steps`` kills individual train steps (each step fires
    once); ``fail_stages`` maps a stage name (as it appears in
    provenance, i.e. including any nesting prefix) to the number of
    consecutive attempts that should die before one succeeds — e.g.
    ``{"train": 2}`` fails the train stage twice, so a policy allowing
    two retries completes on the third attempt.  Counters are guarded by
    a lock because independent stages run on a thread pool.
    """

    fail_at_steps: tuple = ()
    fail_stages: Mapping[str, int] = dataclasses.field(default_factory=dict)
    _fired: set = dataclasses.field(default_factory=set)
    _stage_fired: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")

    def check_stage(self, stage: str) -> None:
        """Raise InjectedFailure for the first ``fail_stages[stage]``
        attempts of ``stage``; later attempts pass."""
        budget = self.fail_stages.get(stage, 0)
        with self._lock:
            fired = self._stage_fired.get(stage, 0)
            if fired >= budget:
                return
            self._stage_fired[stage] = fired + 1
        raise InjectedFailure(
            f"injected stage failure in {stage!r} (attempt {fired + 1})"
        )


@dataclasses.dataclass
class RestartPolicy:
    """How many times to retry, and how long to wait between attempts.

    ``delay(attempt)`` implements capped exponential backoff with jitter:
    ``backoff_s * 2**attempt``, capped at ``max_backoff_s``, then scaled
    by a uniform factor in ``[1, 1 + jitter]`` so a fleet of restarting
    workers doesn't stampede the scheduler in lockstep.  ``backoff_s=0``
    (the test default) disables waiting entirely.  Pass ``seed`` for a
    deterministic jitter sequence (drills that assert on timing).

    ``retry_on`` names the exception classes worth retrying — resource
    failures, not bugs: an assertion error or a shape mismatch will fail
    identically on every attempt, so only transient classes (default:
    :class:`InjectedFailure`, standing in for preemption/node loss, and
    :class:`WorkerLost`, an executor worker dying mid-stage) trigger a
    restart.
    """

    max_restarts: int = 5
    backoff_s: float = 0.0  # base delay; 0 disables backoff (tests)
    max_backoff_s: float = 60.0
    jitter: float = 0.1
    seed: Optional[int] = None
    retry_on: Tuple[type, ...] = (InjectedFailure, WorkerLost)

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, tuple(self.retry_on))

    def _base_delay(self, attempt: int) -> float:
        """The jitterless capped-exponential delay curve — single source
        for ``delay()`` and the expected-backoff budget."""
        return min(self.backoff_s * (2 ** attempt), self.max_backoff_s)

    def delay(self, attempt: int) -> float:
        """Seconds to wait before retry number ``attempt`` (0-based)."""
        if self.backoff_s <= 0:
            return 0.0
        base = self._base_delay(attempt)
        if self.jitter <= 0:
            return base
        rng = random.Random((self.seed << 16) ^ attempt) \
            if self.seed is not None else random
        return base * (1.0 + self.jitter * rng.random())

    def expected_total_backoff_s(self, expected_failures: float) -> float:
        """Expected total seconds spent backing off over a run that
        suffers ``expected_failures`` restarts (fractional values
        interpolate the next delay).  The jitter factor is uniform in
        ``[1, 1 + jitter]``, so its mean is ``1 + jitter/2``.  This is
        the deterministic budget the cost projection folds into a plan's
        expected wall clock (see
        :func:`repro_torch.core.costmodel.retry_expected_cost`)."""
        if self.backoff_s <= 0 or expected_failures <= 0:
            return 0.0
        n = min(expected_failures, float(self.max_restarts))
        whole = int(n)
        total = sum(self._base_delay(i) for i in range(whole))
        frac = n - whole
        if frac > 0:
            total += frac * self._base_delay(whole)
        return total * (1.0 + max(self.jitter, 0.0) / 2.0)


class StragglerWatch:
    """Flags steps whose duration exceeds ``threshold`` × rolling median.

    At fleet scale the mitigation is re-scheduling the slow host; here the
    watch reports, and the envelope records the event in provenance so
    'problems that only appear at scale' stay diagnosable (paper §4.3).
    """

    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.times: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.events: List[Dict] = []

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if duration_s > self.threshold * med:
                is_straggler = True
                self.events.append(
                    {"step": step, "duration_s": duration_s, "median_s": med}
                )
        self.times.append(duration_s)
        return is_straggler


def run_with_restarts(
    run_fn: Callable[[int], int],
    policy: RestartPolicy,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> int:
    """Drive ``run_fn(start_step) -> final_step`` through failures.

    ``run_fn`` must resume from the checkpointed step it is given and
    raise on failure; we restart up to ``max_restarts`` times.
    """
    attempt = 0
    start_step = 0
    while True:
        try:
            return run_fn(start_step)
        except InjectedFailure as e:  # pragma: no branch
            attempt += 1
            if attempt > policy.max_restarts:
                raise
            if on_restart:
                on_restart(attempt, e)
            if policy.backoff_s:
                time.sleep(policy.delay(attempt - 1))
            start_step = -1  # sentinel: run_fn restores from checkpoint
