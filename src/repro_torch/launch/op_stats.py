"""Per-rank FLOP, byte, memory and collective counting of one step, as
eager mode runs it.

Counterpart of the reference package's ``launch/hlo_stats.py``, which
parses the SPMD-partitioned HLO that XLA compiles.  The port compiles no
program: :class:`OpCounter` is a ``TorchDispatchMode`` that sees every
aten op the step runs (the backward's too, and on fake tensors of a fake
world in the dry-run), every collective of ``torch.distributed`` and,
through :mod:`repro_torch.kernels.work`, every call of a hand-written
kernel.  Ops are recorded by signature (op, operand and result shapes
and dtypes, group sizes) with a count, so a saved record (the dry-run's
``--hlo-dir``) can be analyzed again with a changed analyzer
(``launch/reanalyze.py``).  :func:`analyze_ops` turns a record into the
reference's keys, per rank:

  * ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s formulas
    (so they agree with ``FlopCounterMode`` wherever both count), plus
    each kernel call's own (``kernels/work.py``);
  * ``hbm_bytes``: operand and result bytes of every op, except views,
    uninitialised allocations and collectives; a kernel call's bytes are
    its own;
  * ``collective_operand_bytes`` and ``collective_ops`` by kind (the
    reference's kinds), ``collective_bytes_by_group_size`` and
    ``total_collective_bytes``, in the reference's operand convention: an
    all-gather counts its result over the group size, a reduce-scatter its
    result times the group size, the rest their operand.  A collective
    over a group of one rank moves nothing and is not counted;
  * ``transcendentals``, and ``kernels`` (calls, FLOPs and bytes of each).

With ``track_memory`` the counter also follows the live bytes of every
tensor storage the step makes (rounded up to the card allocator's 512
bytes), which gives the ``memory_analysis`` counterparts:
``argument_size_in_bytes`` (the storages passed in, :meth:`OpCounter.
add_arguments`), ``temp_size_in_bytes`` (the peak of live bytes beyond
them) and ``output_size_in_bytes`` / ``alias_size_in_bytes``.
"""
from __future__ import annotations

import collections
import functools
import json
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import work

_ALLOC_ROUND = 512  # bytes: the CUDA caching allocator's granularity

# ops that move no bytes of their own
_NO_TRAFFIC = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.empty_permuted.default",
    "aten._unsafe_view.default", "aten.lift_fresh.default",
}

# ops whose every result element is one transcendental
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log1p", "log2", "tanh",
    "sigmoid", "rsqrt", "sin", "cos", "erf", "silu", "gelu", "softplus",
    "_softmax", "_log_softmax", "logsumexp", "tanh_backward",
    "sigmoid_backward",
}

# the c10d ops of the port's collectives (``parallel/collectives.py``)
# -> (the reference's kind, how the operand bytes follow from the call);
# any other c10d op is listed under ``unknown_collectives``
_COLLECTIVES = {
    "allreduce_": ("all-reduce", "operand"),
    "_allgather_base_": ("all-gather", "result/g"),
    "_reduce_scatter_base_": ("reduce-scatter", "result*g"),
    "alltoall_base_": ("all-to-all", "input"),
}
_NO_PAYLOAD = {"barrier"}


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------
def _group_size(obj) -> Optional[int]:
    from torch._C._distributed_c10d import ProcessGroup

    try:
        return int(ProcessGroup.unbox(obj).size())
    except Exception:  # not a process group (a ReduceOp, a Work)
        return None


_PLAIN = (bool, int, float, str, type(None))
_dtype_name = functools.lru_cache(maxsize=None)(work.dtype_name)


def _itemsize(name: str) -> int:
    return getattr(torch, name).itemsize


def _desc(x) -> Any:
    """A hashable, JSON-able stand-in for one argument or result."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), _dtype_name(x.dtype))
    if type(x) in _PLAIN:
        return x
    if isinstance(x, (list, tuple)):
        return ("L", tuple(map(_desc, x)))
    if isinstance(x, torch.ScriptObject):
        g = _group_size(x)
        return ("G", g) if g is not None else ("O", str(x._type().name()))
    return ("S", str(x))


def _undesc(d) -> Any:
    """Inverse of :func:`_desc` from its JSON form: tensors as meta
    tensors (what the FLOP formulas read: shapes)."""
    if isinstance(d, list):
        d = tuple(d)
    if isinstance(d, tuple) and d and isinstance(d[0], str):
        tag = d[0]
        if tag == "T":
            return torch.empty(tuple(d[1]), dtype=getattr(torch, d[2]),
                               device="meta")
        if tag == "L":
            return [_undesc(v) for v in d[1]]
        return None  # groups, objects and strings feed no formula
    return d


def _tensors(d) -> Iterable[Tuple[Tuple[int, ...], str]]:
    """The (shape, dtype) of every tensor in a descriptor."""
    if isinstance(d, (list, tuple)) and d and d[0] == "T":
        yield tuple(d[1]), d[2]
    elif isinstance(d, (list, tuple)) and d and d[0] == "L":
        for v in d[1]:
            yield from _tensors(v)


def _bytes(d) -> int:
    total = 0
    for shape, dtype in _tensors(d):
        n = 1
        for s in shape:
            n *= s
        total += n * _itemsize(dtype)
    return total


def _numel(d) -> int:
    total = 0
    for shape, _ in _tensors(d):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def _resolve(name: str):
    """The op overload of ``"ns.op.overload"``."""
    ns, op, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, ns), op), overload)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
class OpCounter(TorchDispatchMode):
    """Counts the ops a region runs; ``with OpCounter() as c: step(...)``
    then :meth:`stats`.  Enter it inside a ``FakeTensorMode`` to count a
    step on fake tensors.  While it is active the kernel wrappers count
    their calls with their own work (``kernels/work.py``)."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.ops: Dict[tuple, int] = collections.Counter()
        self.kernels: Dict[tuple, int] = collections.Counter()
        self.track_memory = track_memory
        self._live: Dict[int, Tuple[Any, int]] = {}
        self._args: Dict[int, Tuple[Any, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        work.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            work.pop(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        key = (str(func), tuple(map(_desc, args)),
               tuple(sorted((k, _desc(v)) for k, v in kwargs.items()))
               if kwargs else (), _desc(out))
        self.ops[key] += 1
        if self.track_memory:
            for t in _flat_tensors(out):
                self._track(t)
        return out

    def kernel(self, name: str, params: Dict[str, Any]) -> None:
        """One call of a hand-written kernel (``work.record``)."""
        self.kernels[(name, json.dumps(params, sort_keys=True))] += 1

    # -- memory ------------------------------------------------------------
    @staticmethod
    def _nbytes(st) -> int:
        n = int(st.nbytes())
        return -(-n // _ALLOC_ROUND) * _ALLOC_ROUND

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._args:
            return
        n = self._nbytes(st)

        def gone(_, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

        self._live[key] = (weakref.ref(st, gone), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def add_arguments(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as the step's
        arguments (held before and after it); returns their bytes."""
        for t in _flat_tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._args:
                self._args[st._cdata] = (st, self._nbytes(st))
            if self._live.pop(st._cdata, None) is not None:
                self.live_bytes -= self._nbytes(st)
        return sum(n for _, n in self._args.values())

    def output_bytes(self, tree) -> Tuple[int, int]:
        """``(output bytes, of which aliased to arguments)`` of the
        distinct storages of ``tree``'s tensors."""
        seen: Dict[int, int] = {}
        for t in _flat_tensors(tree):
            st = t.untyped_storage()
            seen[st._cdata] = self._nbytes(st)
        alias = sum(n for k, n in seen.items() if k in self._args)
        return sum(seen.values()), alias

    # -- results -----------------------------------------------------------
    def record(self) -> Dict[str, Any]:
        """The op record: every signature with its count (JSON-able)."""
        return {
            "ops": [[list(k), n] for k, n in self.ops.items()],
            "kernels": [[name, json.loads(p), n]
                        for (name, p), n in self.kernels.items()],
        }

    def stats(self) -> Dict[str, Any]:
        return analyze_ops(self.record())


def _flat_tensors(tree, out: Optional[List[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples.  (A module-level
    function: a recursive closure would be a reference cycle holding the
    tensors until the garbage collector runs, and move the peak.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _flat_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flat_tensors(v, out)
    return out


# ---------------------------------------------------------------------------
# analysis of a record
# ---------------------------------------------------------------------------
def _is_view(op) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in op._schema.returns)


def _op_flops(op, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry

    f = flop_registry.get(op._overloadpacket)
    if f is None:
        return 0.0
    return float(f(*[_undesc(a) for a in args],
                   **{k: _undesc(v) for k, v in kwargs},
                   out_val=_undesc(out)))


def _collective(name: str, args, out) -> Optional[Tuple[str, int, float]]:
    """``(kind, group size, operand bytes)`` of one c10d op, or None."""
    kind, rule = _COLLECTIVES[name]
    groups = [d[1] for d in args if isinstance(d, tuple) and d
              and d[0] == "G"]
    g = groups[0] if groups else 1
    if g <= 1:
        return None
    tensors = [d for d in args if isinstance(d, tuple) and d
               and d[0] in ("T", "L")]
    if rule == "operand":
        b = float(_bytes(tensors[0]))
    elif rule == "input":
        b = float(_bytes(tensors[1]))
    elif rule == "result/g":
        b = _bytes(tensors[0]) / g
    else:
        b = float(_bytes(tensors[0]) * g)
    return kind, g, b


def analyze_ops(record: Dict[str, Any]) -> Dict[str, Any]:
    """The per-rank counts of an op record (see the module docstring)."""
    flops = hbm = trans = 0.0
    calls = 0
    coll_bytes: Dict[str, float] = {}
    coll_ops: Dict[str, float] = {}
    by_group: Dict[int, float] = {}
    unknown: Dict[str, int] = {}
    for key, n in record["ops"]:
        name, args, kwargs, out = (_tuplify(k) for k in key)
        calls += n
        ns, opname, _ = name.split(".")
        if ns == "c10d":
            if opname in _NO_PAYLOAD:
                continue
            if opname not in _COLLECTIVES:
                unknown[opname] = unknown.get(opname, 0) + n
                continue
            c = _collective(opname, args, out)
            if c is None:
                continue
            kind, g, b = c
            coll_bytes[kind] = coll_bytes.get(kind, 0.0) + n * b
            coll_ops[kind] = coll_ops.get(kind, 0.0) + n
            by_group[g] = by_group.get(g, 0.0) + n * b
            continue
        op = _resolve(name)
        flops += n * _op_flops(op, args, kwargs, out)
        if opname in _TRANSCENDENTAL:
            trans += n * _numel(args[0] if opname == "logsumexp" else out)
        if name in _NO_TRAFFIC or _is_view(op):
            continue
        operands = _bytes(("L", args)) + _bytes(("L", tuple(v for _, v in
                                                            kwargs)))
        hbm += n * (operands + _bytes(out))
    kernels: Dict[str, Dict[str, float]] = {}
    for name, params, n in record["kernels"]:
        w = work.work(name, params)
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                      "bytes": 0.0})
        k["calls"] += n
        k["flops"] += n * w["flops"]
        k["bytes"] += n * w["bytes"]
        flops += n * w["flops"]
        hbm += n * w["bytes"]
        trans += n * w["transcendentals"]
    out = {
        "flops": flops,
        "hbm_bytes": hbm,
        "transcendentals": trans,
        "collective_operand_bytes": coll_bytes,
        "collective_ops": coll_ops,
        "collective_bytes_by_group_size": by_group,
        "total_collective_bytes": sum(coll_bytes.values()),
        "kernels": kernels,
        "num_ops": len(record["ops"]),
        "op_calls": calls,
    }
    if unknown:
        out["unknown_collectives"] = unknown
    return out


def collectives_summary(stats: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``parse_collectives`` keys from :func:`analyze_ops`
    output."""
    by_kind = dict(stats["collective_operand_bytes"])
    count = {k: int(v) for k, v in stats["collective_ops"].items()}
    return {"operand_bytes_by_kind": by_kind, "op_count_by_kind": count,
            "total_operand_bytes": sum(by_kind.values()),
            "total_ops": sum(count.values())}


def roofline_terms(stats: Dict[str, Any], chip="h100") -> Dict[str, float]:
    """:func:`analyze_ops` counts as roofline time terms on one chip
    generation (a TPU of ``CHIPS``, the card of ``CARDS`` — ``"h100"`` —
    or a :class:`~repro_torch.core.catalog.ChipSpec`): the seconds the
    step would spend compute-, HBM- and collective-bound at peak rates,
    the terms the analytic cost model emits."""
    from repro_torch.core.catalog import chip_spec

    spec = chip_spec(chip) if isinstance(chip, str) else chip
    return {
        "compute_s": float(stats.get("flops", 0) or 0) / spec.peak_bf16_flops,
        "memory_s": float(stats.get("hbm_bytes", 0) or 0) / spec.hbm_bw,
        "collective_s": (float(stats.get("total_collective_bytes", 0) or 0)
                         / spec.ici_bw),
    }
