"""Pluggable stage executors — the execution substrate behind the graph.

Adviser's pitch is that the *platform* manages parallel or distributed
execution; the user only declares the workflow.  `StageGraph.execute`
keeps its deterministic topological scheduler (the coordinator), but the
*stage body* — ``stage.run(ctx)`` — is dispatched through an
:class:`Executor`, selectable per run:

* :class:`ThreadedExecutor` (``--executor threads``, the default) — the
  body runs inline on the coordinator thread that claimed the stage.
  This is byte-for-byte today's behavior: concurrency comes from the
  graph's coordinator pool, stages share one interpreter.
* :class:`LocalPoolExecutor` (``--executor processes``) — the body of a
  ``process_safe`` stage is marshalled (pickle, the same machinery
  `StageCache`/`RunManifest` persist outputs with) into a
  ``ProcessPoolExecutor`` child, escaping the GIL for CPU-bound
  data/eval stages.  Stages that are not process-safe, or whose inputs
  or outputs refuse to pickle, fall back to inline execution — the
  executor degrades, it never wedges a run.  A child killed mid-stage
  surfaces as :class:`~repro_torch.ft.failures.WorkerLost` (retryable under
  the default `RestartPolicy`) and the pool is rebuilt lazily.
* :class:`WorkerQueueExecutor` (``--executor workers``) — a local
  multi-worker job queue in the scitq/COSMOS job-manager mould: worker
  loops are *recruited* per stage up to the stage's
  ``ResourceIntent.min_chips`` (bounded by ``max_workers``), each claim
  takes a heartbeat-renewed **lease**, a stale-lease reaper requeues
  stages whose worker went silent (emitting ``worker_lost``
  provenance), and the bounded submission queue applies backpressure to
  the coordinator.  Chaos hooks (:meth:`WorkerQueueExecutor.kill_worker`,
  :meth:`WorkerQueueExecutor.drop_heartbeats`) make fault drills
  deterministic — no wall-clock races.

Executors are deliberately *synchronous-friendly*: ``submit`` may run
the body before returning and hand back an already-resolved
:class:`~concurrent.futures.Future`.  Parallelism across stages comes
from the coordinator pool calling ``submit`` from many threads, so a
backend only needs to decide *where* a body runs, never *when*.

A copy of the reference package's ``core/executor.py``.  The pool forks
by default, also from a process that holds the card: only stages that
touch no tensor are ``process_safe`` in the port (the data stage), and
payloads go through :func:`~repro_torch.core.stagecache.host_dumps`,
which refuses a device tensor, so a child never reaches for the card.
"""
from __future__ import annotations

import collections
import itertools
import os
import pickle
import queue
import threading
import time
from concurrent.futures import Future, ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.stagecache import host_dumps
from repro_torch.ft.failures import WorkerLost

EXECUTOR_KINDS = ("threads", "processes", "workers")


class UnpicklableOutputs(RuntimeError):
    """Raised *inside* a pool child when a stage's outputs refuse to
    pickle; the parent falls back to re-running the body inline.
    Module-level so the exception itself crosses the process boundary.
    """


def _inline_run(stage, ctx) -> Dict[str, Any]:
    """The one true inline body: exactly what graph.py historically ran."""
    return stage.run(ctx) or {}


def _log_event(ctx, kind: str, **payload) -> None:
    record = getattr(ctx, "record", None)
    if record is not None:
        record.log_event(kind, dict(payload))


class Executor:
    """Where stage bodies run.

    The protocol is three methods — ``submit(stage, ctx, ...) -> Future``,
    ``capacity()`` and ``shutdown()``.  ``schedule_width`` advertises how
    many bodies the backend can usefully hold in flight; the graph sizes
    its coordinator pool to at least this so a wide backend is never
    starved by a narrow coordinator.
    """

    kind: str = "base"
    schedule_width: int = 1

    def submit(self, stage, ctx, *, name: Optional[str] = None,
               placement=None, prefix: str = "") -> "Future":
        raise NotImplementedError

    def capacity(self) -> int:
        return self.schedule_width

    def shutdown(self, wait: bool = True) -> None:  # pragma: no cover - trivial
        pass

    def stats(self) -> Dict[str, Any]:
        return {"kind": self.kind, "capacity": self.capacity()}

    # context-manager sugar so examples/benches can ``with make_executor(...)``
    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class ThreadedExecutor(Executor):
    """Today's behavior, made explicit: the body runs inline on the
    coordinator thread that claimed the stage.  ``workers`` only sets the
    advertised ``schedule_width`` (how wide the graph's coordinator pool
    opens up); there is no second thread pool to hop through.
    """

    kind = "threads"

    def __init__(self, workers: int = 4):
        self.schedule_width = max(1, int(workers))
        self._submitted = 0

    def submit(self, stage, ctx, *, name=None, placement=None, prefix=""):
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        self._submitted += 1
        try:
            fut.set_result(_inline_run(stage, ctx))
        except BaseException as exc:  # noqa: BLE001 - future carries it
            fut.set_exception(exc)
        return fut

    def stats(self):
        return {"kind": self.kind, "capacity": self.capacity(),
                "submitted": self._submitted}


# --------------------------------------------------------------------------
# Process pool
# --------------------------------------------------------------------------

def _child_run(payload: bytes) -> Tuple[int, bytes]:
    """Pool-child entrypoint: rebuild a bare `StageContext` and run the
    stage body.  Returns ``(pid, pickled outputs)`` so the parent can
    attribute the work in provenance.
    """
    from repro_torch.core.graph import StageContext

    stage, outputs, params, template = pickle.loads(payload)
    ctx = StageContext(template=template, record=None, params=params,
                       outputs=outputs)
    out = _inline_run(stage, ctx)
    try:
        blob = host_dumps(out)
    except Exception as exc:
        raise UnpicklableOutputs(
            f"stage {stage.name!r} outputs do not pickle: {exc}") from None
    return os.getpid(), blob


def _pickle_filter(mapping: Dict[str, Any]) -> Dict[str, Any]:
    """Drop entries that refuse to pickle (locks, schedules, live torch
    state).  A process-safe stage only depends on its declared inputs,
    which are persistable by the cache contract."""
    keep = {}
    for key, value in mapping.items():
        try:
            host_dumps(value)
        except Exception:
            continue
        keep[key] = value
    return keep


class LocalPoolExecutor(Executor):
    """`ProcessPoolExecutor`-backed stage bodies — escapes the GIL.

    Only stages marked ``process_safe`` (pure functions of their
    picklable inputs: `DataStage`, `EvalStage`, user stages that opt in)
    are dispatched to children; everything else runs inline on the
    coordinator thread.  Marshalling ships ``(stage, picklable ctx
    outputs, picklable params, template)`` — the same pickle surface the
    stage cache persists — and unpicklable *inputs or outputs* fall back
    inline rather than failing the run.

    A pool child dying mid-stage (OOM-kill, SIGKILL chaos drills)
    surfaces as :class:`WorkerLost`, which the default `RestartPolicy`
    retries; the broken pool is discarded and rebuilt on the next
    submit.  Note a pool break takes *all* in-flight bodies with it —
    per-item blast-radius isolation is the worker queue's job.
    """

    kind = "processes"

    def __init__(self, workers: Optional[int] = None, mp_context: Optional[str] = None,
                 warm: bool = True):
        self.workers = max(1, int(workers or min(4, os.cpu_count() or 1)))
        self.schedule_width = self.workers
        # fork avoids re-importing __main__ (and works for script-less
        # parents); children only run pure-Python stage bodies, so the
        # usual fork-with-threads hazards (CUDA, BLAS pools) stay out of
        # the child's execution path.
        self._mp_method = mp_context or ("fork" if hasattr(os, "fork") else "spawn")
        self._lock = threading.Lock()
        self._pool: Optional[ProcessPoolExecutor] = None
        self._rebuilds = 0
        self._inline_fallbacks = 0
        self._dispatched = 0
        if warm:
            self._ensure_pool()

    # -- pool lifecycle ----------------------------------------------------
    def _ensure_pool(self) -> ProcessPoolExecutor:
        with self._lock:
            if self._pool is None:
                import multiprocessing as mp

                self._pool = ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=mp.get_context(self._mp_method))
                # Force worker spawn now, from the calling thread, so
                # forks don't happen at an arbitrary later moment.
                self._pool.submit(os.getpid).result()
            return self._pool

    def _discard_pool(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
            self._rebuilds += 1
        if pool is not None:
            pool.shutdown(wait=False)

    def worker_pids(self) -> List[int]:
        """Live child pids — the chaos hook SIGKILL drills target."""
        pool = self._ensure_pool()
        with self._lock:
            procs = getattr(pool, "_processes", None) or {}
            return [pid for pid, proc in dict(procs).items() if proc.is_alive()]

    # -- dispatch ----------------------------------------------------------
    def submit(self, stage, ctx, *, name=None, placement=None, prefix=""):
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        try:
            fut.set_result(self._run_body(stage, ctx, name or stage.name))
        except BaseException as exc:  # noqa: BLE001 - future carries it
            fut.set_exception(exc)
        return fut

    def _run_body(self, stage, ctx, name: str) -> Dict[str, Any]:
        if not (getattr(stage, "dispatchable", True)
                and getattr(stage, "process_safe", False)):
            return self._inline(stage, ctx, name, reason="not process-safe")
        payload = self._marshal(stage, ctx)
        if payload is None:
            return self._inline(stage, ctx, name, reason="unpicklable stage")
        pool = self._ensure_pool()
        try:
            pid, blob = pool.submit(_child_run, payload).result()
        except UnpicklableOutputs:
            return self._inline(stage, ctx, name, reason="unpicklable outputs")
        except BrokenProcessPool as exc:
            self._discard_pool()
            raise WorkerLost(
                f"process-pool worker died while running stage {name!r}") from exc
        self._dispatched += 1
        _log_event(ctx, "stage_worker", stage=name, worker=f"pid:{pid}",
                   backend=self.kind)
        out = pickle.loads(blob)
        return out

    def _inline(self, stage, ctx, name: str, *, reason: str) -> Dict[str, Any]:
        self._inline_fallbacks += 1
        _log_event(ctx, "stage_worker", stage=name, worker="inline",
                   backend=self.kind, fallback=reason)
        return _inline_run(stage, ctx)

    def _marshal(self, stage, ctx) -> Optional[bytes]:
        with ctx._lock:
            outputs = dict(ctx.outputs)
        params = dict(getattr(ctx, "params", {}) or {})
        template = getattr(ctx, "template", None)
        try:
            return host_dumps((stage, outputs, params, template))
        except Exception:
            pass
        # Second pass: drop the unpicklable entries (FailureSchedule
        # carries a lock, live model state may not pickle) and retry.
        outputs = _pickle_filter(outputs)
        params = _pickle_filter(params)
        for candidate in ((stage, outputs, params, template),
                          (stage, outputs, params, None)):
            try:
                return host_dumps(candidate)
            except Exception:
                continue
        return None

    def capacity(self) -> int:
        return self.workers

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait)

    def stats(self):
        return {"kind": self.kind, "capacity": self.workers,
                "dispatched": self._dispatched,
                "inline_fallbacks": self._inline_fallbacks,
                "pool_rebuilds": self._rebuilds}


# --------------------------------------------------------------------------
# Worker queue
# --------------------------------------------------------------------------

class _Worker:
    __slots__ = ("id", "thread", "alive", "killed", "beats_dropped",
                 "current", "last_beat", "claim_epoch")

    def __init__(self, wid: str):
        self.id = wid
        self.thread: Optional[threading.Thread] = None
        self.alive = True
        self.killed = False          # chaos: stop executing + stop beating
        self.beats_dropped = False   # chaos: keep executing, stop beating
        self.current: Optional["_QueueItem"] = None
        self.last_beat = time.monotonic()
        self.claim_epoch = -1


class _QueueItem:
    __slots__ = ("seq", "stage", "ctx", "name", "placement", "prefix",
                 "future", "attempts", "epoch")

    def __init__(self, seq: int, stage, ctx, name: str, placement, prefix: str):
        self.seq = seq
        self.stage = stage
        self.ctx = ctx
        self.name = name
        self.placement = placement
        self.prefix = prefix
        self.future: Future = Future()
        self.future.set_running_or_notify_cancel()
        self.attempts = 0
        # Bumped by the reaper on every revocation; a worker's completion
        # only counts if the epoch it claimed under is still current —
        # zombie results from reaped workers are discarded, never
        # double-resolved.
        self.epoch = 0


class WorkerQueueExecutor(Executor):
    """A local multi-worker job queue with leases, heartbeats and a
    stale-lease reaper — the single-host rehearsal of a distributed
    worker fleet (scitq recruits workers per step the same way).

    * **Recruitment** is elastic: the fleet starts at ``workers`` loops
      and grows toward a stage's ``ResourceIntent.min_chips`` (capped at
      ``max_workers``) when a bigger stage arrives; idle surplus workers
      retire back down to the floor.
    * **Leases**: claiming a stage takes a lease (``stage_lease``
      provenance).  A maintenance thread renews heartbeats for healthy
      workers; a worker whose heartbeat goes stale for ``lease_s`` has
      its lease revoked by the reaper — the stage is requeued
      (``worker_lost`` provenance, up to ``max_requeues`` times, after
      which :class:`WorkerLost` surfaces to the retry policy) and a
      replacement worker is recruited.
    * **Backpressure**: the submission queue is bounded
      (``queue_size``); `submit` blocks the coordinator thread when the
      fleet is saturated.  Requeued work bypasses the bound (the reaper
      must never deadlock against a full queue).

    Chaos hooks: :meth:`kill_worker` (worker stops executing *and*
    beating — a crashed process), :meth:`drop_heartbeats` (worker keeps
    executing but goes silent — a network partition; its eventual result
    is discarded as a zombie).
    """

    kind = "workers"

    def __init__(self, workers: int = 2, max_workers: Optional[int] = None,
                 queue_size: int = 64, lease_s: float = 1.0,
                 poll_s: float = 0.02, max_requeues: int = 2):
        self.workers = max(1, int(workers))
        self.max_workers = max(self.workers, int(max_workers or self.workers * 4))
        self.schedule_width = self.max_workers
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.max_requeues = int(max_requeues)
        self._queue: "queue.Queue[_QueueItem]" = queue.Queue(maxsize=max(1, queue_size))
        self._requeued: "collections.deque[_QueueItem]" = collections.deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._workers: List[_Worker] = []
        self._running = True
        self._seq = itertools.count()
        self._wid = itertools.count(1)
        self._inflight = 0
        self._completed = 0
        self._requeues = 0
        self._discarded_zombies = 0
        self._recruited_total = 0
        for _ in range(self.workers):
            self._spawn_worker_locked_free()
        self._maint = threading.Thread(target=self._maintenance_loop,
                                       name="workerqueue-maint", daemon=True)
        self._maint.start()

    # -- fleet management --------------------------------------------------
    def _spawn_worker_locked_free(self) -> _Worker:
        worker = _Worker(f"w{next(self._wid)}")
        worker.thread = threading.Thread(target=self._worker_loop,
                                         args=(worker,),
                                         name=f"workerqueue-{worker.id}",
                                         daemon=True)
        with self._lock:
            self._workers.append(worker)
            self._recruited_total += 1
        worker.thread.start()
        return worker

    def _alive_locked(self) -> List[_Worker]:
        return [w for w in self._workers if w.alive and not w.killed]

    def _desired_for(self, stage) -> int:
        intent = getattr(stage, "intent", None)
        want = self.workers
        if intent is not None and getattr(intent, "min_chips", None):
            want = max(want, int(intent.min_chips))
        return min(self.max_workers, want)

    def _recruit_for(self, stage, ctx, name: str) -> None:
        want = self._desired_for(stage)
        spawned = []
        while True:
            with self._lock:
                if not self._running or len(self._alive_locked()) >= want:
                    break
            spawned.append(self._spawn_worker_locked_free().id)
        if spawned:
            _log_event(ctx, "worker_recruited", stage=name, workers=spawned,
                       fleet=self.capacity())

    # -- submission --------------------------------------------------------
    def submit(self, stage, ctx, *, name=None, placement=None, prefix=""):
        with self._lock:
            if not self._running:
                raise RuntimeError("WorkerQueueExecutor is shut down")
            self._inflight += 1
        item = _QueueItem(next(self._seq), stage, ctx, name or stage.name,
                          placement, prefix)
        self._recruit_for(stage, ctx, item.name)
        self._queue.put(item)  # bounded: blocks the coordinator = backpressure
        return item.future

    # -- worker loop -------------------------------------------------------
    def _claim_locked(self) -> Optional[_QueueItem]:
        if self._requeued:
            return self._requeued.popleft()
        return None

    def _worker_loop(self, worker: _Worker) -> None:
        while True:
            with self._lock:
                if not self._running or worker.killed:
                    worker.alive = False
                    self._cond.notify_all()
                    return
                item = self._claim_locked()
            if item is None:
                try:
                    item = self._queue.get(timeout=self.poll_s)
                except queue.Empty:
                    # surplus worker with nothing to do retires back to
                    # the fleet floor
                    with self._lock:
                        surplus = (len(self._alive_locked()) > self.workers
                                   and not self._requeued
                                   and self._queue.empty())
                        if surplus:
                            worker.alive = False
                            self._cond.notify_all()
                            return
                    continue
            with self._lock:
                if not self._running or worker.killed:
                    # hand the claim back rather than dropping it
                    self._requeued.appendleft(item)
                    worker.alive = False
                    self._cond.notify_all()
                    return
                item.attempts += 1
                worker.current = item
                worker.last_beat = time.monotonic()
                worker.claim_epoch = item.epoch
                attempt = item.attempts
            _log_event(item.ctx, "stage_lease", stage=item.name,
                       worker=worker.id, attempt=attempt,
                       lease_s=self.lease_s)
            out = err = None
            try:
                # the body runs on *this* thread, not the coordinator's:
                # re-establish the thread-local placement/prefix the
                # coordinator bound (ctx.current_placement contract)
                tls = getattr(item.ctx, "_tls", None)
                if tls is not None:
                    tls.placement = item.placement
                    tls.prefix = item.prefix
                out = _inline_run(item.stage, item.ctx)
            except BaseException as exc:  # noqa: BLE001 - future carries it
                err = exc
            with self._lock:
                stale = item.epoch != worker.claim_epoch
                if worker.current is item:
                    worker.current = None
                if stale:
                    # the reaper revoked this lease mid-flight; the item
                    # was requeued (or failed over) — this result is a
                    # zombie and must be discarded, not double-resolved.
                    self._discarded_zombies += 1
                    continue
            if err is not None:
                self._resolve(item, error=err)
            else:
                _log_event(item.ctx, "stage_worker", stage=item.name,
                           worker=worker.id, backend=self.kind,
                           attempt=attempt)
                self._resolve(item, result=out)

    def _resolve(self, item: _QueueItem, result=None, error=None) -> None:
        if error is not None:
            item.future.set_exception(error)
        else:
            item.future.set_result(result)
        with self._lock:
            self._inflight -= 1
            self._completed += 1
            self._cond.notify_all()

    # -- maintenance: heartbeats + stale-lease reaper ----------------------
    def _maintenance_loop(self) -> None:
        while True:
            time.sleep(self.poll_s)
            lost: List[Tuple[_Worker, _QueueItem, bool]] = []
            with self._lock:
                if not self._running:
                    return
                now = time.monotonic()
                for worker in self._workers:
                    if not worker.alive:
                        continue
                    if not (worker.killed or worker.beats_dropped):
                        worker.last_beat = now  # healthy worker heartbeat
                        continue
                    item = worker.current
                    if item is None:
                        continue
                    if now - worker.last_beat < self.lease_s:
                        continue
                    # lease expired: revoke, requeue (or fail over)
                    item.epoch += 1
                    worker.current = None
                    worker.killed = True  # a reaped worker never rejoins
                    requeue = item.attempts <= self.max_requeues
                    if requeue:
                        self._requeues += 1
                        self._requeued.append(item)
                    lost.append((worker, item, requeue))
            for worker, item, requeue in lost:
                _log_event(item.ctx, "worker_lost", stage=item.name,
                           worker=worker.id, attempt=item.attempts,
                           requeued=requeue)
                if requeue:
                    # keep the fleet at strength for the retry
                    self._recruit_for(item.stage, item.ctx, item.name)
                else:
                    self._resolve(item, error=WorkerLost(
                        f"stage {item.name!r} lost its worker "
                        f"{item.attempts} time(s); requeue budget "
                        f"({self.max_requeues}) exhausted"))

    # -- chaos hooks -------------------------------------------------------
    def kill_worker(self, worker_id: Optional[str] = None) -> Optional[str]:
        """Simulate a worker crash: it stops heartbeating *and* executing
        (its in-flight result, if any, is discarded).  Returns the id of
        the killed worker, preferring one that is mid-stage."""
        with self._lock:
            candidates = [w for w in self._alive_locked()]
            if worker_id is not None:
                candidates = [w for w in candidates if w.id == worker_id]
            busy = [w for w in candidates if w.current is not None]
            target = (busy or candidates or [None])[0]
            if target is None:
                return None
            target.killed = True
            return target.id

    def drop_heartbeats(self, worker_id: Optional[str] = None) -> Optional[str]:
        """Simulate a network partition: the worker keeps executing but
        goes silent, so the reaper revokes its lease and its eventual
        result is discarded as a zombie."""
        with self._lock:
            candidates = [w for w in self._alive_locked()]
            if worker_id is not None:
                candidates = [w for w in candidates if w.id == worker_id]
            busy = [w for w in candidates if w.current is not None]
            target = (busy or candidates or [None])[0]
            if target is None:
                return None
            target.beats_dropped = True
            return target.id

    # -- introspection / lifecycle ----------------------------------------
    def worker_ids(self) -> List[str]:
        with self._lock:
            return [w.id for w in self._alive_locked()]

    def capacity(self) -> int:
        with self._lock:
            return len(self._alive_locked())

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted stage has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining if remaining is not None else 0.1)
        return True

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            self.drain()
        with self._lock:
            if not self._running:
                return
            self._running = False
            workers = list(self._workers)
            self._cond.notify_all()
        for worker in workers:
            if worker.thread is not None and wait:
                worker.thread.join(timeout=5.0)
        if wait and self._maint.is_alive():
            self._maint.join(timeout=5.0)
        # anything still unresolved (zombies revoked past their budget at
        # shutdown, claims handed back with no fleet left) fails loudly
        pending: List[_QueueItem] = []
        with self._lock:
            pending.extend(self._requeued)
            self._requeued.clear()
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for item in pending:
            if not item.future.done():
                self._resolve(item, error=RuntimeError(
                    f"executor shut down with stage {item.name!r} pending"))

    def stats(self):
        with self._lock:
            return {"kind": self.kind,
                    "capacity": len(self._alive_locked()),
                    "fleet_floor": self.workers,
                    "fleet_ceiling": self.max_workers,
                    "inflight": self._inflight,
                    "completed": self._completed,
                    "requeues": self._requeues,
                    "discarded_zombies": self._discarded_zombies,
                    "recruited_total": self._recruited_total}


def make_executor(kind: str, workers: Optional[int] = None, **kw) -> Executor:
    """CLI-facing factory: ``threads`` / ``processes`` / ``workers``."""
    kind = (kind or "threads").lower()
    if kind == "threads":
        return ThreadedExecutor(workers=workers or 4)
    if kind == "processes":
        return LocalPoolExecutor(workers=workers, **kw)
    if kind == "workers":
        return WorkerQueueExecutor(workers=workers or 2, **kw)
    raise ValueError(
        f"unknown executor kind {kind!r}; expected one of {EXECUTOR_KINDS}")
