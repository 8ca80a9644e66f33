"""Content-addressed cross-run stage cache, plus the per-run manifest
that makes interrupted runs resumable (``run --resume``).

A copy of the reference package's ``core/stagecache.py``.  Every key
also names the package (:data:`PACKAGE`), so the port and the reference
can share one cache directory and one run store without either ever
restoring (unpickling) the other's outputs.

Workflow runtime is dominated by redundant recomputation across runs
(Juve et al., arXiv:1005.2718): a sweep's fan-out re-executes the same
data-prep stage per run, and re-running a workflow after an unrelated
edit re-executes every stage.  This cache lets the scheduler skip a
stage whose inputs are provably identical to a prior execution.

The hash key
------------
A stage's **input hash** is ``stable_hash`` of the package's name and
four components, computed
by :meth:`repro_torch.core.graph.StageGraph` right before the stage would run:

  1. **stage signature** — the stage's type, name, ``cache_version``
     salt (bump it when the stage's implementation — or code it calls
     into — changes output semantics, so stale entries can't hit),
     declared inputs and outputs, and its JSON-able constructor
     configuration (e.g. ``DataStage.build_stream``), so two
     differently-configured instances of one class never collide;
  2. **declared inputs** — a structural description of the context value
     behind every key in ``stage.inputs`` (arrays describe as
     dtype+shape, dataclasses by full field content, primitives by
     value);
  3. **upstream output hashes** — the ``outputs_hash`` of each
     dependency's produced outputs, chaining provenance so an upstream
     change invalidates every stage below it;
  4. **scoped run knobs** — the template fields named by
     ``stage.cache_template_fields`` (None means the whole template
     config) and the context params named by ``stage.cache_params``,
     which is how e.g. a data stage keys on (arch, shape, scale, data
     config, smoke batch/seq) but not on an optimizer override.

Because array values describe structurally (dtype+shape, not content),
the key detects *wiring* changes, not bitwise array differences — only
stages whose outputs are a pure function of the hashed components
should set ``cacheable = True`` (the built-in DataStage qualifies: its
stream is a pure function of seed + config).

Storage is a plain directory — ``<root>/<hash>.pkl`` (pickled outputs)
with a ``<hash>.json`` sidecar (stage name, creation time, original
duration, sizes) — no services required, mirroring the provenance
store's philosophy.  Writes are atomic (temp file + rename) so
concurrent runs can share a cache root.  ``repro run --no-cache``
bypasses it; ``repro cache stats`` / ``repro cache clear`` inspect and
reset it.

Size bound: ``max_bytes`` (or ``$REPRO_CACHE_MAX_BYTES``) turns on LRU
eviction — every hit touches the payload's mtime, and each ``put``
evicts least-recently-used entries until the payload total fits.  The
bound is per-insert best-effort (concurrent writers may transiently
overshoot); ``stats()`` reports the configured bound and session
eviction count.

Resumable runs
--------------
:class:`RunManifest` applies the same content addressing *within* one
run: as each stage completes, its outputs are pickled under
``<run_dir>/stages/<name>.pkl`` and an entry ``{input_hash,
outputs_hash, completed_at}`` is appended to
``<run_dir>/stage_manifest.json``.  When a crashed run is re-executed
with ``repro run --resume <run_id>``, the scheduler recomputes each
stage's input hash; a match restores the recorded outputs (emitting
``stage_cached`` provenance with ``resume: true``) instead of
re-running the stage, so only the incomplete suffix of the graph
executes.  Stages whose outputs cannot be pickled simply re-run.

The manifest trades disk + one pickle per completed stage for
resumability; StageCache hits record hash-only entries (their payload
already lives in the cross-run cache), and runs that will never be
resumed can opt out entirely with ``run_workflow(resume_store=False)``
/ ``repro run --no-run-manifest``.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import torch

try:  # POSIX advisory locks; Windows falls back to lock-free best effort
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

DEFAULT_CACHE_DIR = ".repro_cache/stages"
# salts every cache and resume key (repro_torch.core.graph)
PACKAGE = "repro_torch"


class _FileLock:
    """Cross-process advisory lock (flock) around a sentinel file.

    Multi-process executors (`repro_torch.core.executor.LocalPoolExecutor`) and
    concurrent runs sharing one cache/run directory serialize their
    read-modify-write sections through this; where ``fcntl`` is missing
    it degrades to a no-op and the atomic-rename writes remain
    last-writer-wins.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def __enter__(self) -> "_FileLock":
        if fcntl is not None:
            try:
                self._fh = open(self.path, "a+")
                fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
            except OSError:
                if self._fh is not None:
                    self._fh.close()
                self._fh = None
        return self

    def __exit__(self, *exc) -> None:
        if self._fh is not None:
            try:
                fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            except OSError:
                pass
            self._fh.close()
            self._fh = None


def _atomic_write(tmp_dir: str, final_path: str, payload: bytes) -> bool:
    """Write bytes via temp file + rename (concurrent-writer safe).
    Returns False instead of raising on OS errors — callers treat a
    failed persist as 'never cached', not a run failure."""
    fd, tmp = tempfile.mkstemp(dir=tmp_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, final_path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    return True


class _HostPickler(pickle.Pickler):
    """A pickler that refuses a tensor on a device other than the CPU: a
    payload unpickled in another process (a resume, a process-pool child)
    must not reach for the card the writer held."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise pickle.PicklingError(
                f"a tensor on {obj.device} does not go into a stage payload")
        return NotImplemented


def host_dumps(obj: Any) -> bytes:
    """``pickle.dumps`` of a value that holds no device tensor; raises
    ``pickle.PicklingError`` otherwise."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def default_cache_dir() -> str:
    return os.environ.get("REPRO_CACHE_DIR", DEFAULT_CACHE_DIR)


def default_max_bytes() -> Optional[int]:
    raw = os.environ.get("REPRO_CACHE_MAX_BYTES")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"REPRO_CACHE_MAX_BYTES must be an integer byte count, got {raw!r}"
        ) from None


class StageCache:
    """Persistent stage-output store keyed by content-addressed input hash.

    ``max_bytes`` bounds the total payload size with LRU eviction on
    insert (None/0 = unbounded; defaults to ``$REPRO_CACHE_MAX_BYTES``)."""

    def __init__(self, root: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self.root = root or default_cache_dir()
        self.max_bytes = default_max_bytes() if max_bytes is None else max_bytes
        os.makedirs(self.root, exist_ok=True)
        # session counters (per-process; `stats()` also scans the disk)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.unpicklable = 0
        self.evictions = 0

    def _payload_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """The cached outputs dict for an input hash, or None on miss.
        A corrupt/unreadable entry counts as a miss (and is removed)."""
        path = self._payload_path(key)
        try:
            with open(path, "rb") as f:
                outputs = pickle.load(f)
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception:
            self.misses += 1
            for p in (path, self._meta_path(key)):
                try:
                    os.remove(p)
                except OSError:
                    pass
            return None
        self.hits += 1
        try:
            os.utime(path)  # LRU touch: eviction keys off payload mtime
        except OSError:
            pass
        return outputs

    def put(self, key: str, stage: str, outputs: Dict[str, Any],
            duration_s: float) -> bool:
        """Persist a stage's outputs under its input hash.  Returns False
        (without raising) when the outputs cannot be pickled — such
        stages simply never hit."""
        try:
            payload = host_dumps(outputs)
        except Exception:
            self.unpicklable += 1
            return False
        if not _atomic_write(self.root, self._payload_path(key), payload):
            return False
        meta = {
            "stage": stage,
            "created": time.time(),
            "duration_s": duration_s,
            "outputs": sorted(outputs),
            "bytes": len(payload),
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, self._meta_path(key))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
        self.puts += 1
        self._evict()
        return True

    def _evict(self) -> None:
        """Drop least-recently-used payloads until the total fits
        ``max_bytes`` (mtime is the recency clock: refreshed on every
        hit, so unread entries age out first).  The scan-and-remove is
        serialized across processes by an advisory lock so two
        concurrent runs sharing a cache root don't both act on the same
        stale byte count and over-evict each other's fresh entries."""
        if not self.max_bytes:
            return
        with _FileLock(os.path.join(self.root, ".evict.lock")):
            self._evict_locked()

    def _evict_locked(self) -> None:
        entries = []
        total = 0
        for name in os.listdir(self.root):
            if not name.endswith(".pkl"):
                continue
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, name[:-4]))
            total += st.st_size
        entries.sort()  # oldest first
        for mtime, size, key in entries:
            if total <= self.max_bytes:
                break
            for p in (self._payload_path(key), self._meta_path(key)):
                try:
                    os.remove(p)
                except OSError:
                    pass
            total -= size
            self.evictions += 1

    # ------------------------------------------------------------------
    def entries(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            key = name[:-5]
            try:
                with open(os.path.join(self.root, name)) as f:
                    out[key] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
        return out

    def stats(self) -> Dict[str, Any]:
        entries = self.entries()
        by_stage: Dict[str, int] = {}
        saved = 0.0
        total = 0
        for meta in entries.values():
            by_stage[meta.get("stage", "?")] = by_stage.get(meta.get("stage", "?"), 0) + 1
            saved += float(meta.get("duration_s", 0.0))
            total += int(meta.get("bytes", 0))
        return {
            "root": self.root,
            "entries": len(entries),
            "bytes": total,
            "max_bytes": self.max_bytes,
            "cached_wall_s": saved,   # wall time a full re-run would skip
            "by_stage": by_stage,
            "session": {"hits": self.hits, "misses": self.misses,
                        "puts": self.puts, "unpicklable": self.unpicklable,
                        "evictions": self.evictions},
        }

    def clear(self) -> int:
        """Delete every entry; returns the number of entries removed."""
        n = 0
        for name in os.listdir(self.root):
            if name.endswith(".pkl"):
                n += 1
            if name.endswith((".pkl", ".json", ".tmp")):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        return n


# ===========================================================================
# Per-run completed-stage manifest (resume support)
# ===========================================================================
def _safe_filename(stage: str) -> str:
    """Stage names may contain nesting separators ('prep/tokenize');
    map them to a filesystem-safe, collision-free payload name."""
    import hashlib

    clean = "".join(c if c.isalnum() or c in "._-" else "_" for c in stage)
    digest = hashlib.sha256(stage.encode()).hexdigest()[:8]
    return f"{clean}-{digest}"


class RunManifest:
    """Durable record of one run's completed stages, for ``--resume``.

    Lives inside the run's provenance directory:

        <run_dir>/stage_manifest.json   # {stage: {input_hash, outputs_hash,
                                        #          payload, completed_at, ...}}
        <run_dir>/stages/<stage>.pkl    # the stage's pickled outputs

    The scheduler calls :meth:`record` after every successful stage and
    :meth:`lookup`/:meth:`load_outputs` before running one: a stage whose
    recomputed input hash matches its recorded entry is skipped and its
    outputs restored, so a crashed run re-executes only the incomplete
    suffix of the graph.  Writes are atomic (temp file + rename),
    thread-lock-guarded — independent stages complete concurrently on
    the scheduler's thread pool — and *cross-process* safe: each flush
    takes an advisory file lock and merges the on-disk entries with this
    writer's before rewriting, so two processes recording into one run
    directory (multi-process executors, two resumed runs racing) lose no
    completed stages.  A same-stage race is last-writer-wins, which is
    benign: both writers recorded the same content-addressed hashes.
    """

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.stages_dir = os.path.join(run_dir, "stages")
        self.path = os.path.join(run_dir, "stage_manifest.json")
        self.lock_path = os.path.join(run_dir, ".stage_manifest.lock")
        os.makedirs(self.stages_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._entries = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._entries = {}

    def _payload_path(self, stage: str) -> str:
        return os.path.join(self.stages_dir, f"{_safe_filename(stage)}.pkl")

    def _read_disk(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as f:
                disk = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        return disk if isinstance(disk, dict) else {}

    def _flush_locked(self) -> None:
        # merge-on-flush under a cross-process lock: adopt entries other
        # processes recorded since our last read, let our own entries win
        # for the stages *we* completed, and write the union atomically.
        with _FileLock(self.lock_path):
            merged = self._read_disk()
            merged.update(self._entries)
            self._entries = merged
            fd, tmp = tempfile.mkstemp(dir=self.run_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(self._entries, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)

    # ------------------------------------------------------------------
    def record(self, stage: str, input_hash: str, outputs_hash: str,
               outputs: Dict[str, Any], duration_s: float,
               store_payload: bool = True) -> bool:
        """Persist a completed stage.  Returns False (entry still written,
        marked payload-less) when the outputs cannot be pickled — such
        stages re-run on resume instead of restoring.  Pass
        ``store_payload=False`` to record only the hashes: the scheduler
        does this for StageCache hits, whose payload already lives in the
        cross-run cache (a resume misses the manifest, falls through to
        the cache, and hits there — no duplicate pickle)."""
        payload_ok = store_payload
        if payload_ok:
            try:
                payload = host_dumps(outputs)
            except Exception:
                payload_ok = False
        if payload_ok:
            payload_ok = _atomic_write(self.stages_dir,
                                       self._payload_path(stage), payload)
        with self._lock:
            self._entries[stage] = {
                "input_hash": input_hash,
                "outputs_hash": outputs_hash,
                "outputs": sorted(outputs),
                "payload": payload_ok,
                "duration_s": duration_s,
                "completed_at": time.time(),
            }
            try:
                self._flush_locked()
            except OSError:
                return False
        return payload_ok

    # ------------------------------------------------------------------
    def lookup(self, stage: str, input_hash: str) -> Optional[Dict[str, Any]]:
        """The recorded entry for ``stage`` iff its input hash still
        matches and a restorable payload exists."""
        with self._lock:
            entry = self._entries.get(stage)
        if entry is None or entry.get("input_hash") != input_hash:
            return None
        if not entry.get("payload"):
            return None
        return dict(entry)

    def load_outputs(self, stage: str,
                     input_hash: str) -> Optional[Dict[str, Any]]:
        """The pickled outputs of a completed stage, or None (corrupt or
        hash-mismatched entries re-run rather than restoring)."""
        if self.lookup(stage, input_hash) is None:
            return None
        try:
            with open(self._payload_path(stage), "rb") as f:
                return pickle.load(f)
        except Exception:
            return None

    def completed(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}
