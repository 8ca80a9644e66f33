"""Standardized execution envelope (paper §4.3): every run — laptop smoke
test or 512-chip production job — goes through the same lifecycle:

    restore-or-init → [step → observe → checkpoint?] * N → validate → report

with structured logging, heartbeats, straggler detection, failure recovery
and provenance capture.  Scale-induced problems become diagnosable because
every run leaves the same records behind.

A copy of the reference package's ``core/envelope.py`` on the port's
:class:`~repro_torch.checkpoint.Checkpointer`.  ``run(...,
state_shardings=)`` restores onto those layouts (each rank its block of
each leaf, on the layouts' mesh) and saves through them (each leaf
gathered whole, written by rank 0); without them a restore puts each
leaf on the device of the freshly initialised state's leaf.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.provenance import RunRecord
from repro_torch.ft.failures import FailureSchedule, InjectedFailure, RestartPolicy, StragglerWatch

Pytree = Any


class ExecutionEnvelope:
    def __init__(
        self,
        record: RunRecord,
        checkpointer: Optional[Checkpointer] = None,
        checkpoint_every: int = 50,
        straggler: Optional[StragglerWatch] = None,
        failures: Optional[FailureSchedule] = None,
        restart_policy: Optional[RestartPolicy] = None,
    ):
        self.record = record
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.straggler = straggler or StragglerWatch()
        self.failures = failures
        self.restart_policy = restart_policy or RestartPolicy()
        self.restarts = 0

    # ------------------------------------------------------------------
    def run(
        self,
        *,
        init_state: Callable[[], Pytree],
        step_fn: Callable[[Pytree, int], tuple],
        num_steps: int,
        state_shardings: Optional[Pytree] = None,
    ) -> Pytree:
        """Drive the full lifecycle.  ``step_fn(state, step) -> (state,
        metrics)``.  Failures (InjectedFailure) trigger restore-from-
        checkpoint restarts up to the policy limit."""
        attempt = 0
        while True:
            try:
                return self._run_once(init_state, step_fn, num_steps,
                                      state_shardings)
            except InjectedFailure as e:
                attempt += 1
                self.restarts = attempt
                self.record.log_event("failure", {"error": str(e), "attempt": attempt})
                if attempt > self.restart_policy.max_restarts:
                    raise
                if self.restart_policy.backoff_s:
                    time.sleep(self.restart_policy.delay(attempt - 1))

    def _run_once(self, init_state, step_fn, num_steps,
                  state_shardings) -> Pytree:
        state = None
        start = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            like = init_state()
            state, start = self.ckpt.restore(like, shardings=state_shardings)
            start += 1
            self.record.log_event("restore", {"step": start - 1})
        if state is None:
            state = init_state()
            self.record.log_event("init", {})

        for step in range(start, num_steps):
            if self.failures is not None:
                self.failures.check(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, step)
            dt = time.perf_counter() - t0
            if self.straggler.observe(step, dt):
                self.record.log_event(
                    "straggler", {"step": step, "duration_s": dt}
                )
            self.record.log(step, {**metrics, "step_time_s": dt})
            if (
                self.ckpt is not None
                and self.checkpoint_every
                and (step + 1) % self.checkpoint_every == 0
            ):
                self.ckpt.save(step, state, shardings=state_shardings)
        if self.ckpt is not None:
            self.ckpt.save(num_steps - 1, state, blocking=True,
                           shardings=state_shardings)
        return state
