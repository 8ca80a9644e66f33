"""RunQueue — many concurrent workflow runs over one shared executor.

The platform promise in the source paper is fleet-shaped: users hand the
platform many workflows and it "manages parallel or distributed
execution" across them.  :class:`RunQueue` is that service in-process: a
bounded pool of *run drivers* (each drives one `StageGraph`/
`run_workflow` invocation) sharing a single stage
:class:`~repro_torch.core.executor.Executor`, with

* **per-run fairness** — each run sees the shared backend through a
  :class:`_FairView` that caps its in-flight stage bodies at
  ``capacity // active_runs`` (floor 1), so one wide run cannot starve
  the others of workers;
* **graceful drain** — :meth:`RunQueue.drain` stops admissions and
  waits for every accepted run to settle, the shutdown path an operator
  uses before retiring a fleet.

Tickets (:class:`RunTicket`) are the observable handle: status,
timestamps, the run's result future, and the peak concurrency it was
actually granted (``max_in_flight`` — what the fairness tests assert).

A copy of the reference package's ``core/runqueue.py`` over the port's
executors; ``submit_workflow`` passes ``device`` (and every other
argument) to :func:`repro_torch.core.workflow.run_workflow`.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.executor import Executor


class RunQueueClosed(RuntimeError):
    """submit() after drain()/shutdown() — the queue no longer admits."""


class RunTicket:
    """The handle for one queued run."""

    def __init__(self, name: str, seq: int):
        self.name = name
        self.seq = seq
        self.status = "queued"  # queued -> running -> done | failed
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.in_flight = 0       # stage bodies currently granted
        self.max_in_flight = 0   # observed peak grant (fairness witness)
        self.future: Future = Future()

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.future.result(timeout=timeout)

    def done(self) -> bool:
        return self.future.done()

    def as_doc(self) -> Dict[str, Any]:
        return {"name": self.name, "seq": self.seq, "status": self.status,
                "max_in_flight": self.max_in_flight,
                "submitted_at": self.submitted_at,
                "started_at": self.started_at,
                "finished_at": self.finished_at}

    def __repr__(self):
        return f"<RunTicket {self.name!r} #{self.seq} {self.status}>"


class _FairView(Executor):
    """A run's window onto the shared executor.

    ``submit`` blocks until the run is under its fair share of the
    backend's capacity, forwards to the shared executor, and releases
    the grant when the body's future resolves.  The share is dynamic —
    recomputed from the number of *currently active* runs — so capacity
    freed by a finishing run flows to the survivors without rebalancing
    machinery.
    """

    def __init__(self, rq: "RunQueue", ticket: RunTicket, shared: Executor):
        self._rq = rq
        self._ticket = ticket
        self._shared = shared
        self.kind = shared.kind
        self.schedule_width = getattr(shared, "schedule_width", 1)

    def submit(self, stage, ctx, **kw) -> Future:
        rq, ticket = self._rq, self._ticket
        with rq._cond:
            while (ticket.in_flight >= rq._share()
                   and not rq._stopping):
                rq._cond.wait(0.05)
            ticket.in_flight += 1
            ticket.max_in_flight = max(ticket.max_in_flight,
                                       ticket.in_flight)
        try:
            fut = self._shared.submit(stage, ctx, **kw)
        except BaseException:
            with rq._cond:
                ticket.in_flight -= 1
                rq._cond.notify_all()
            raise

        def _release(_):
            with rq._cond:
                ticket.in_flight -= 1
                rq._cond.notify_all()

        fut.add_done_callback(_release)
        return fut

    def capacity(self) -> int:
        return self._shared.capacity()

    def shutdown(self, wait: bool = True) -> None:
        # the shared executor is the RunQueue's to close, not one run's
        pass


class RunQueue:
    """Schedule many workflow runs against one shared stage executor.

    ``max_active`` bounds how many runs *drive* concurrently (each
    active run holds one driver thread); every driver dispatches its
    stage bodies through the shared ``executor`` behind a fairness
    window.  Close out with :meth:`drain` (graceful: wait for accepted
    work) or :meth:`shutdown`.
    """

    def __init__(self, executor: Executor, max_active: int = 4,
                 own_executor: bool = False):
        self.executor = executor
        self.max_active = max(1, int(max_active))
        self._own_executor = own_executor
        self._drivers = ThreadPoolExecutor(max_workers=self.max_active,
                                           thread_name_prefix="runqueue")
        self._cond = threading.Condition()
        self._tickets: List[RunTicket] = []
        self._active = 0
        self._accepting = True
        self._stopping = False
        self._seq = itertools.count(1)

    # -- fairness ----------------------------------------------------------
    def _share(self) -> int:
        """Per-run in-flight cap: an equal split of the backend's
        capacity among currently-active runs, never below 1."""
        cap = max(1, self.executor.capacity())
        return max(1, cap // max(1, self._active))

    # -- admission ---------------------------------------------------------
    def submit(self, name: str,
               fn: Callable[[Executor], Any]) -> RunTicket:
        """Queue ``fn(executor_view)``; returns its ticket immediately.

        ``fn`` receives this run's fair view of the shared executor —
        pass it straight through as ``run_workflow(..., executor=view)``
        or ``graph.execute(ctx, executor=view)``.
        """
        with self._cond:
            if not self._accepting:
                raise RunQueueClosed("RunQueue is draining; no new runs")
            ticket = RunTicket(name, next(self._seq))
            self._tickets.append(ticket)
        self._drivers.submit(self._drive, ticket, fn)
        return ticket

    def submit_workflow(self, template, store, *, name: Optional[str] = None,
                        **run_kw) -> RunTicket:
        """Queue a full ``run_workflow`` invocation (convenience)."""
        from repro_torch.core.workflow import run_workflow

        def _drive_workflow(view: Executor):
            return run_workflow(template, store, executor=view, **run_kw)

        return self.submit(name or getattr(template, "name", "run"),
                           _drive_workflow)

    # -- the driver --------------------------------------------------------
    def _drive(self, ticket: RunTicket, fn) -> None:
        with self._cond:
            self._active += 1
            ticket.status = "running"
            ticket.started_at = time.time()
            self._cond.notify_all()
        try:
            out = fn(_FairView(self, ticket, self.executor))
        except BaseException as exc:  # noqa: BLE001 - ticket carries it
            with self._cond:
                ticket.status = "failed"
                ticket.finished_at = time.time()
                self._active -= 1
                self._cond.notify_all()
            ticket.future.set_exception(exc)
            return
        with self._cond:
            ticket.status = "done"
            ticket.finished_at = time.time()
            self._active -= 1
            self._cond.notify_all()
        ticket.future.set_result(out)

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, wait for every accepted run to settle.
        Returns False if ``timeout`` elapsed with runs still going."""
        with self._cond:
            self._accepting = False
            tickets = list(self._tickets)
        deadline = None if timeout is None else time.monotonic() + timeout
        for ticket in tickets:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            try:
                ticket.future.exception(timeout=remaining)
            except (_FutureTimeout, TimeoutError):
                return False
        return True

    def shutdown(self, wait: bool = True) -> None:
        with self._cond:
            self._accepting = False
            self._stopping = True
            self._cond.notify_all()
        self._drivers.shutdown(wait=wait)
        if self._own_executor:
            self.executor.shutdown(wait=wait)

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            by_status: Dict[str, int] = {}
            for t in self._tickets:
                by_status[t.status] = by_status.get(t.status, 0) + 1
            return {"runs": len(self._tickets), "active": self._active,
                    "accepting": self._accepting,
                    "by_status": by_status,
                    "executor": self.executor.stats()}

    def tickets(self) -> List[RunTicket]:
        with self._cond:
            return list(self._tickets)

    def __enter__(self) -> "RunQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
        self.shutdown()
