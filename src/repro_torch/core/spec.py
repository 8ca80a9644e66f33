"""Declarative workflow specs: serialize a StageGraph to a versioned,
schema-validated document and back (paper §4.1 — workflows as shareable,
expert-crafted artifacts a non-expert can inspect and run).

A *spec* is a plain JSON-able dict (stored as ``.json`` or, when PyYAML
is available, ``.yaml``) describing a workflow completely: stages with
their declared input/output ports, dependency edges, per-stage resource
intents, retry policies, placement bindings and cache/resume knobs —
everything the static checker (:mod:`repro_torch.core.check`) needs *before*
any cloud resource is provisioned, and everything ``from_spec`` needs to
rebuild an executable graph.

Three document kinds share the ``spec_version`` envelope:

  * ``kind: workflow`` — one stage graph (:func:`to_spec` /
    :func:`from_spec`);
  * ``kind: package`` — a workflow bundled with its template and run
    params into one shareable artifact (:func:`pack_template` /
    :func:`unpack_package`; the CLI's ``pack`` / ``unpack`` verbs);
  * nested ``graph`` blocks — subworkflow stages serialize their inner
    graph recursively.

Determinism: :func:`dumps_spec` renders with sorted keys and a fixed
indent, and :func:`to_spec` round-trips its result through JSON, so the
same graph always yields byte-identical text — specs diff cleanly and
golden files stay stable.

What does *not* survive serialization (each refused loudly rather than
dropped silently):

  * non-JSON-able constructor knobs (callables, live objects) become
    ``{"__opaque__": <type>}`` markers; ``from_spec(strict=True)``
    refuses to rebuild an executable stage from them and the checker
    flags them on cacheable stages (ADV008);
  * ``RestartPolicy.retry_on`` (a tuple of exception *classes*) —
    reconstructed policies use the default retryable set;
  * ``FnStage`` bodies — wrap real logic in a named Stage subclass and
    :func:`register_stage_type` it to make a workflow shareable.

A copy of the reference package's ``core/spec.py`` over the port's
stages: a spec the reference writes loads here, and the port's
templates write the reference's specs (the golden file
``tests/golden/train-qwen2-1.5b.spec.json``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.core.graph import Stage, StageContext, StageGraph, _SubworkflowStage
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.stages import (
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
from repro_torch.ft.failures import RestartPolicy

SPEC_VERSION = "1"

# entry fields every stage entry carries (validate_spec rejects others)
_ENTRY_KEYS = frozenset({
    "name", "type", "depends_on", "inputs", "outputs", "config",
    "intent", "retry", "placement_key", "checks", "cacheable",
    "cache_params", "cache_template_fields", "cache_version",
    "resume_payload", "unpicklable_outputs", "graph", "inner_retry",
    "meta",
})
_DOC_KEYS = frozenset({
    "spec_version", "kind", "name", "stages", "external_inputs",
    "results", "waivers", "budget_usd", "meta",
})
_PACKAGE_KEYS = frozenset({
    "spec_version", "kind", "name", "template", "workflow", "params",
    "meta",
})
_RETRY_FIELDS = ("max_restarts", "backoff_s", "max_backoff_s", "jitter",
                 "seed")


class SpecError(ValueError):
    """A spec document that can't be validated or reconstructed."""


# ===========================================================================
# Stage-type registry
# ===========================================================================
STAGE_TYPES: Dict[str, Type[Stage]] = {}
_TYPE_NAMES: Dict[Type[Stage], str] = {}


def register_stage_type(type_name: str, cls: Type[Stage]) -> None:
    """Make a Stage subclass reconstructable from specs under
    ``type_name`` (and serialized under it by :func:`to_spec`).  The
    class must honor the ``spec_config`` / ``from_spec_config``
    contract (see :class:`repro_torch.core.graph.Stage`)."""
    STAGE_TYPES[type_name] = cls
    _TYPE_NAMES[cls] = type_name


for _tname, _tcls in (
    ("plan", PlanStage), ("data", DataStage), ("train", TrainStage),
    ("serve", ServeStage), ("explore", ExploreStage), ("eval", EvalStage),
    ("validate", ValidateStage), ("visualize", VisualizeStage),
    ("move", MoveStage), ("calibrate", CalibrateStage),
):
    register_stage_type(_tname, _tcls)


class DeclaredStage(Stage):
    """A stage known only by declaration — ports, deps and config from a
    spec, no executable body.

    ``from_spec(strict=False)`` falls back to this for unknown types and
    opaque configs so the *static checker* can analyze any well-formed
    spec; authors can also use ``type: declared`` directly to sketch a
    workflow's dataflow before the implementation exists.  Executing one
    raises :class:`SpecError`.
    """

    def __init__(self, name: str, inputs: Sequence[str] = (),
                 outputs: Sequence[str] = (),
                 declared_type: str = "declared",
                 config: Optional[Dict[str, Any]] = None):
        super().__init__(name)
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.declared_type = declared_type
        self.declared_config = dict(config or {})

    def spec_config(self) -> Dict[str, Any]:
        return dict(self.declared_config)

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        raise SpecError(
            f"stage {self.name!r} (type {self.declared_type!r}) is "
            f"declaration-only: its spec could not be bound to an "
            f"executable stage class (register one with "
            f"repro_torch.core.spec.register_stage_type)"
        )


register_stage_type("declared", DeclaredStage)


def _type_name(stage: Stage) -> str:
    if isinstance(stage, _SubworkflowStage):
        return "subworkflow"
    if isinstance(stage, DeclaredStage):
        return stage.declared_type
    return _TYPE_NAMES.get(type(stage), type(stage).__name__)


def opaque_paths(config: Any, _prefix: str = "") -> List[str]:
    """Dotted paths of every ``{"__opaque__": ...}`` marker in a spec
    config block — non-empty means the config can't rebuild a stage."""
    out: List[str] = []
    if isinstance(config, dict):
        if set(config) == {"__opaque__"}:
            return [_prefix.rstrip(".") or "<config>"]
        for k, v in config.items():
            out.extend(opaque_paths(v, f"{_prefix}{k}."))
    elif isinstance(config, list):
        for i, v in enumerate(config):
            out.extend(opaque_paths(v, f"{_prefix}{i}."))
    return out


# ===========================================================================
# Graph -> spec
# ===========================================================================
def _intent_doc(intent: Optional[ResourceIntent]) -> Optional[Dict[str, Any]]:
    return dataclasses.asdict(intent) if intent is not None else None


def _retry_doc(retry: Optional[RestartPolicy]) -> Optional[Dict[str, Any]]:
    # retry_on holds exception *classes* — not serializable; reloaded
    # policies fall back to the default retryable set (module docstring)
    if retry is None:
        return None
    return {f: getattr(retry, f) for f in _RETRY_FIELDS}


def _stage_entry(name: str, stage: Stage,
                 depends_on: Tuple[str, ...]) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "name": name,
        "type": _type_name(stage),
        "depends_on": list(depends_on),
        "inputs": list(stage.inputs),
        "outputs": list(stage.outputs),
        "config": stage.spec_config(),
        "intent": _intent_doc(stage.intent),
        "retry": _retry_doc(stage.retry),
        "placement_key": stage.placement_key,
        "checks": list(stage.checks) if stage.checks is not None else None,
        "cacheable": stage.cacheable,
        "cache_params": list(stage.cache_params),
        "cache_template_fields": (list(stage.cache_template_fields)
                                  if stage.cache_template_fields is not None
                                  else None),
        "cache_version": stage.cache_version,
        "resume_payload": stage.resume_payload,
        "unpicklable_outputs": list(stage.unpicklable_outputs),
    }
    if isinstance(stage, _SubworkflowStage):
        entry["graph"] = to_spec(stage.graph)
        entry["inner_retry"] = _retry_doc(stage.inner_retry)
    return entry


def default_results(graph: StageGraph) -> List[str]:
    """The keys a workflow is *for*: every produced-but-unconsumed
    output.  ``to_spec`` records them so the dead-output lint (ADV002)
    knows terminal artifacts from genuinely dropped values."""
    produced = [k for s in graph.stages.values() for k in s.outputs]
    consumed = {k for s in graph.stages.values() for k in s.inputs}
    return sorted(set(produced) - consumed)


def to_spec(graph: StageGraph, *, name: Optional[str] = None,
            results: Optional[Sequence[str]] = None,
            waivers: Sequence[Dict[str, Any]] = (),
            external_inputs: Sequence[str] = (),
            budget_usd: Optional[float] = None) -> Dict[str, Any]:
    """Serialize a graph into a workflow spec document (pure JSON types,
    byte-deterministic through :func:`dumps_spec`).

    ``results`` defaults to :func:`default_results`; ``external_inputs``
    names keys the runner seeds (params, pre-loaded context) so the
    checker doesn't flag them as unproduced; ``waivers`` are
    per-diagnostic suppressions (``{"code", "stage", "reason"}``, stage
    None = any); ``budget_usd`` attaches the envelope the over-budget
    check (ADV007) enforces.
    """
    graph.validate()
    doc = {
        "spec_version": SPEC_VERSION,
        "kind": "workflow",
        "name": name or graph.name,
        "external_inputs": sorted(set(external_inputs)),
        "results": (sorted(set(results)) if results is not None
                    else default_results(graph)),
        "waivers": [dict(w) for w in waivers],
        "budget_usd": budget_usd,
        "stages": [_stage_entry(n, graph.stages[n], graph.deps(n))
                   for n in graph.stages],  # insertion order
    }
    # normalize tuples/np scalars through the JSON renderer so the
    # returned dict contains exactly what a reloaded file would
    return json.loads(dumps_spec(doc))


# ===========================================================================
# Spec -> graph
# ===========================================================================
def _apply(stage: Stage, attr: str, value: Any) -> None:
    """Set an entry-level attribute only when it differs from what the
    constructor produced — keeps ``vars(stage)`` (and therefore cache
    signatures) identical for faithful round-trips."""
    if getattr(stage, attr) != value:
        setattr(stage, attr, value)


def _build_stage(entry: Dict[str, Any], strict: bool) -> Stage:
    name = entry["name"]
    tname = entry["type"]
    config = entry.get("config") or {}
    if tname == "subworkflow":
        inner = from_spec(entry["graph"], strict=strict)
        inner_retry = _retry_from(entry.get("inner_retry"))
        return inner.as_stage(name,
                              max_workers=int(config.get("max_workers", 4)),
                              retry=inner_retry)
    cls = STAGE_TYPES.get(tname)
    opaque = opaque_paths(config)
    if cls is None or (opaque and cls is not DeclaredStage):
        why = (f"unknown stage type {tname!r}" if cls is None else
               f"opaque config value(s) at {', '.join(opaque)}")
        if strict:
            raise SpecError(
                f"stage {name!r}: {why} — cannot rebuild an executable "
                f"stage (load with strict=False for analysis-only, or "
                f"register the type via register_stage_type)")
        return DeclaredStage(name, inputs=entry.get("inputs", ()),
                             outputs=entry.get("outputs", ()),
                             declared_type=tname, config=config)
    if cls is DeclaredStage:
        # declaration-only stages take their ports from the entry, not
        # from config (which is free-form author metadata)
        return DeclaredStage(name, inputs=entry.get("inputs", ()),
                             outputs=entry.get("outputs", ()),
                             declared_type=tname, config=config)
    try:
        stage = cls.from_spec_config(name, config)
    except TypeError as e:
        raise SpecError(
            f"stage {name!r}: config does not match {cls.__name__} "
            f"constructor ({e})") from e
    return stage


def _retry_from(doc: Optional[Dict[str, Any]]) -> Optional[RestartPolicy]:
    if doc is None:
        return None
    return RestartPolicy(**{f: doc[f] for f in _RETRY_FIELDS if f in doc})


def _intent_from(doc: Optional[Dict[str, Any]]) -> Optional[ResourceIntent]:
    if doc is None:
        return None
    kw = dict(doc)
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    try:
        return ResourceIntent(**kw)
    except TypeError as e:
        raise SpecError(f"bad intent block {sorted(doc)}: {e}") from e


def from_spec(doc: Dict[str, Any], *, strict: bool = True) -> StageGraph:
    """Rebuild a StageGraph from a workflow spec document.

    ``strict=True`` (the default, what ``run`` uses) requires every
    stage to bind to a registered executable class with a fully
    concrete config; ``strict=False`` (what ``check`` uses) degrades
    unknown types and opaque configs to :class:`DeclaredStage` so
    static analysis works on any well-formed spec.  Either way the
    declared ports must match what the stage class derives from its
    config — a drifted spec fails here, not mid-run.
    """
    errors = validate_spec(doc)
    if errors:
        raise SpecError("invalid spec: " + "; ".join(errors))
    g = StageGraph(doc["name"])
    for entry in doc["stages"]:
        stage = _build_stage(entry, strict)
        declared_in = tuple(entry.get("inputs", ()))
        declared_out = tuple(entry.get("outputs", ()))
        if not isinstance(stage, DeclaredStage):
            if (tuple(stage.inputs) != declared_in
                    or tuple(stage.outputs) != declared_out):
                raise SpecError(
                    f"stage {entry['name']!r}: declared ports "
                    f"(in={list(declared_in)}, out={list(declared_out)}) "
                    f"do not match what {type(stage).__name__} derives "
                    f"from its config (in={list(stage.inputs)}, "
                    f"out={list(stage.outputs)}) — the spec has drifted "
                    f"from the stage implementation")
        _apply(stage, "intent", _intent_from(entry.get("intent")))
        _apply(stage, "retry", _retry_from(entry.get("retry")))
        _apply(stage, "placement_key", entry.get("placement_key"))
        checks = entry.get("checks")
        _apply(stage, "checks",
               tuple(checks) if checks is not None else None)
        _apply(stage, "cacheable", bool(entry.get("cacheable", False)))
        _apply(stage, "cache_params", tuple(entry.get("cache_params", ())))
        ctf = entry.get("cache_template_fields")
        _apply(stage, "cache_template_fields",
               tuple(ctf) if ctf is not None else None)
        _apply(stage, "cache_version", entry.get("cache_version", "1"))
        _apply(stage, "resume_payload",
               bool(entry.get("resume_payload", True)))
        _apply(stage, "unpicklable_outputs",
               tuple(entry.get("unpicklable_outputs", ())))
        g.add(stage, depends_on=tuple(entry.get("depends_on", ())))
    return g


# ===========================================================================
# Schema validation (hand-rolled: no jsonschema dependency)
# ===========================================================================
def _type_err(where: str, what: str, value: Any) -> str:
    return f"{where}: expected {what}, got {type(value).__name__}"


def _check_str_list(errors: List[str], where: str, value: Any) -> None:
    if not isinstance(value, list) or not all(
            isinstance(x, str) for x in value):
        errors.append(_type_err(where, "a list of strings", value))


def validate_spec(doc: Any) -> List[str]:
    """Schema errors for a spec document (empty list = valid).  Checks
    the envelope, required fields, field types, stage-name uniqueness
    and unknown keys — the ADV010 layer; graph-structure problems
    (cycles, unknown deps) surface when the graph is built (ADV011)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [_type_err("document", "a mapping", doc)]
    version = doc.get("spec_version")
    if version is None:
        errors.append("missing required field 'spec_version'")
    elif str(version) != SPEC_VERSION:
        errors.append(f"unsupported spec_version {version!r} "
                      f"(this build reads {SPEC_VERSION!r})")
    kind = doc.get("kind", "workflow")
    if kind == "package":
        for unknown in sorted(set(doc) - _PACKAGE_KEYS):
            errors.append(f"unknown package field {unknown!r}")
        wf = doc.get("workflow")
        if not isinstance(wf, dict):
            errors.append(_type_err("package 'workflow'", "a mapping", wf))
        else:
            errors.extend(validate_spec(wf))
        if "params" in doc and not isinstance(doc["params"], dict):
            errors.append(_type_err("package 'params'", "a mapping",
                                    doc["params"]))
        return errors
    if kind != "workflow":
        errors.append(f"unknown kind {kind!r} (expected 'workflow' or "
                      f"'package')")
        return errors
    for unknown in sorted(set(doc) - _DOC_KEYS):
        errors.append(f"unknown workflow field {unknown!r}")
    if not isinstance(doc.get("name"), str) or not doc.get("name"):
        errors.append("workflow 'name' must be a non-empty string")
    for key in ("external_inputs", "results"):
        if key in doc:
            _check_str_list(errors, f"workflow {key!r}", doc[key])
    if "waivers" in doc:
        if not isinstance(doc["waivers"], list):
            errors.append(_type_err("workflow 'waivers'", "a list",
                                    doc["waivers"]))
        else:
            for i, w in enumerate(doc["waivers"]):
                if not isinstance(w, dict) or not isinstance(
                        w.get("code"), str):
                    errors.append(f"waivers[{i}]: must be a mapping with "
                                  f"a string 'code'")
    if "budget_usd" in doc and doc["budget_usd"] is not None \
            and not isinstance(doc["budget_usd"], (int, float)):
        errors.append(_type_err("workflow 'budget_usd'", "a number",
                                doc["budget_usd"]))
    stages = doc.get("stages")
    if not isinstance(stages, list):
        errors.append(_type_err("workflow 'stages'", "a list", stages))
        return errors
    seen: Dict[str, int] = {}
    for i, entry in enumerate(stages):
        where = f"stages[{i}]"
        if not isinstance(entry, dict):
            errors.append(_type_err(where, "a mapping", entry))
            continue
        name = entry.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where}: 'name' must be a non-empty string")
        elif name in seen:
            errors.append(f"{where}: duplicate stage name {name!r} "
                          f"(first at stages[{seen[name]}])")
        else:
            seen[name] = i
            where = f"stages[{i}] ({name!r})"
        if not isinstance(entry.get("type"), str):
            errors.append(f"{where}: 'type' must be a string")
        for unknown in sorted(set(entry) - _ENTRY_KEYS):
            errors.append(f"{where}: unknown field {unknown!r}")
        for key in ("depends_on", "inputs", "outputs", "cache_params",
                    "unpicklable_outputs"):
            if key in entry:
                _check_str_list(errors, f"{where} {key!r}", entry[key])
        for key in ("checks", "cache_template_fields"):
            if entry.get(key) is not None and key in entry:
                _check_str_list(errors, f"{where} {key!r}", entry[key])
        if "config" in entry and not isinstance(entry["config"], dict):
            errors.append(_type_err(f"{where} 'config'", "a mapping",
                                    entry["config"]))
        for key in ("intent", "retry"):
            if entry.get(key) is not None and not isinstance(
                    entry[key], dict):
                errors.append(_type_err(f"{where} {key!r}", "a mapping",
                                        entry[key]))
        if entry.get("type") == "subworkflow":
            if not isinstance(entry.get("graph"), dict):
                errors.append(f"{where}: subworkflow entries need a "
                              f"'graph' block")
            else:
                errors.extend(f"{where}.graph: {e}"
                              for e in validate_spec(entry["graph"]))
    return errors


# ===========================================================================
# Rendering & files
# ===========================================================================
def dumps_spec(doc: Dict[str, Any]) -> str:
    """The canonical text rendering: sorted keys, fixed indent, trailing
    newline — byte-identical for equal documents."""
    return json.dumps(doc, indent=1, sort_keys=True, default=_json_default) \
        + "\n"


def _json_default(v: Any) -> Any:
    if isinstance(v, tuple):
        return list(v)
    if hasattr(v, "item"):  # numpy scalar
        return v.item()
    raise TypeError(f"not spec-serializable: {type(v).__name__}")


def dump_spec(doc: Dict[str, Any], path: str) -> None:
    """Write a spec to ``path``; format chosen by extension (``.json``
    canonical; ``.yaml``/``.yml`` when PyYAML is installed)."""
    if path.endswith((".yaml", ".yml")):
        yaml = _yaml()
        text = yaml.safe_dump(doc, sort_keys=True,
                              default_flow_style=False)
    else:
        text = dumps_spec(doc)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def load_spec(path: str) -> Dict[str, Any]:
    """Read a spec document from a ``.json`` / ``.yaml`` file (no
    validation — pair with :func:`validate_spec` / :func:`from_spec`)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        doc = _yaml().safe_load(text)
    else:
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(doc, dict):
        raise SpecError(f"{path}: expected a mapping at top level")
    return doc


def _yaml():
    try:
        import yaml
    except ImportError as e:  # pragma: no cover - env-dependent
        raise SpecError(
            "YAML specs need PyYAML, which is not installed — use the "
            ".json form (canonical) instead") from e
    return yaml


# ===========================================================================
# Templates: serialize, package, register
# ===========================================================================
def template_to_spec(t: Any) -> Dict[str, Any]:
    """A WorkflowTemplate as pure JSON types (nested data/optimizer
    configs by field)."""
    return json.loads(json.dumps(dataclasses.asdict(t),
                                 default=_json_default))


def template_from_spec(doc: Dict[str, Any]) -> Any:
    from repro_torch.core.workflow import WorkflowTemplate
    from repro_torch.data import DataConfig
    from repro_torch.train import OptimizerConfig

    kw = dict(doc)
    unknown = sorted(set(kw) - {f.name for f in
                                dataclasses.fields(WorkflowTemplate)})
    if unknown:
        raise SpecError(f"unknown template field(s) {unknown}")
    try:
        if isinstance(kw.get("data"), dict):
            kw["data"] = DataConfig(**kw["data"])
        if isinstance(kw.get("optimizer"), dict):
            opt = dict(kw["optimizer"])
            if isinstance(opt.get("betas"), list):
                opt["betas"] = tuple(opt["betas"])
            kw["optimizer"] = OptimizerConfig(**opt)
        if isinstance(kw.get("checks"), list):
            kw["checks"] = tuple(kw["checks"])
        return WorkflowTemplate(**kw)
    except TypeError as e:
        raise SpecError(f"bad template block: {e}") from e


def default_waivers(t: Any) -> List[Dict[str, Any]]:
    """The waivers canonical templates ship with.  ADV005 (cross-slice
    handoff without a movement stage) is waived because the bundled
    executor is single-process: every stage shares one in-memory
    blackboard, so the handoff is logical until a movement lowering
    (:func:`repro_torch.core.check.insert_movement_stages`) is applied."""
    return [{
        "code": "ADV005",
        "stage": None,
        "reason": "single-process executor shares one in-memory "
                  "blackboard; apply insert_movement_stages to make "
                  "cross-slice handoffs explicit",
    }]


def spec_for_template(t: Any, *, with_eval: bool = False) -> Dict[str, Any]:
    """The canonical workflow spec of a registry template: its compiled
    graph serialized with the template's default waivers."""
    from repro_torch.core.workflow import compile_template

    g = compile_template(t, with_eval=with_eval)
    return to_spec(g, name=t.name, waivers=default_waivers(t))


def pack_template(t: Any, *, with_eval: bool = False,
                  params: Optional[Dict[str, Any]] = None,
                  ) -> Dict[str, Any]:
    """Bundle template + compiled workflow + run params into one
    shareable package document (the CLI's ``pack``)."""
    doc = {
        "spec_version": SPEC_VERSION,
        "kind": "package",
        "name": t.name,
        "template": template_to_spec(t),
        "workflow": spec_for_template(t, with_eval=with_eval),
        "params": dict(params or {}),
    }
    return json.loads(dumps_spec(doc))


def unpack_package(doc: Dict[str, Any]) -> Tuple[Any, Dict[str, Any],
                                                 Dict[str, Any]]:
    """(template, workflow_doc, params) from a package document.  The
    workflow doc is returned unparsed so the caller picks strictness."""
    errors = validate_spec(doc)
    if errors:
        raise SpecError("invalid package: " + "; ".join(errors))
    if doc.get("kind") != "package":
        raise SpecError(f"expected kind 'package', got {doc.get('kind')!r}")
    template = None
    if doc.get("template") is not None:
        template = template_from_spec(doc["template"])
    return template, doc["workflow"], dict(doc.get("params") or {})


def load_workflow(path: str, *, strict: bool = True,
                  ) -> Tuple[Optional[Any], StageGraph, Dict[str, Any],
                             Dict[str, Any]]:
    """One-call loader for either document kind on disk:
    ``(template, graph, params, workflow_doc)``.  Workflow-kind files
    yield ``template=None`` and empty params."""
    doc = load_spec(path)
    if doc.get("kind") == "package":
        template, wf_doc, params = unpack_package(doc)
    else:
        template, wf_doc, params = None, doc, {}
    return template, from_spec(wf_doc, strict=strict), params, wf_doc


__all__ = [
    "SPEC_VERSION", "SpecError", "STAGE_TYPES", "DeclaredStage",
    "register_stage_type", "opaque_paths", "to_spec", "from_spec",
    "default_results", "validate_spec", "dumps_spec", "dump_spec",
    "load_spec", "template_to_spec", "template_from_spec",
    "default_waivers", "spec_for_template", "pack_template",
    "unpack_package", "load_workflow",
]
