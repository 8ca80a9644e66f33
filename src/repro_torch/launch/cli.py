"""The port's CLI: the reference's ``repro`` commands on the port's
control plane (``repro_torch.core``), with ``--device`` on ``run``.

    # run a curated workflow by name on the card (the default device)
    python -m repro_torch.launch.cli run train-qwen2-1.5b --steps 20

    # ... or on the CPU (the plain versions of the kernels)
    python -m repro_torch.launch.cli run train-qwen2-1.5b --device cpu --steps 4
    python -m repro_torch.launch.cli run serve-qwen2-1.5b --device cpu \
        --serve-engine paged --serve-spec-k 4

    # run only part of the workflow DAG: the named stage(s) + ancestors
    python -m repro_torch.launch.cli run train-qwen2-1.5b --stage data --stage plan

    # include the held-out eval stage between train and validate
    python -m repro_torch.launch.cli run train-qwen2-1.5b --with-eval --steps 20

    # render a template's stage graph (topological order, deps, stage
    # inputs/outputs and per-stage intents), with each stage's backend
    python -m repro_torch.launch.cli graph train-qwen2-1.5b --placements

    # intent-based resource selection (no hardware names)
    python -m repro_torch.launch.cli plan --arch glm4-9b --shape train_4k \
        --goal production --budget 400

    # catalog / templates / runs / the cross-run stage cache
    python -m repro_torch.launch.cli catalog
    python -m repro_torch.launch.cli templates
    python -m repro_torch.launch.cli runs --runs-dir runs
    python -m repro_torch.launch.cli compare RUN_A RUN_B
    python -m repro_torch.launch.cli cache stats

    # resilience: retry stages on (injected) node loss, resume a crashed
    # run from its run manifest + newest committed checkpoint
    python -m repro_torch.launch.cli run train-qwen2-1.5b --stage-retries 2
    python -m repro_torch.launch.cli run train-qwen2-1.5b --resume RUN_ID

Every flag of the reference's ``plan``, ``run``, ``graph``, ``catalog``,
``templates``, ``runs``, ``compare`` and ``cache`` is here.  ``explore``,
``calibrate``, ``check``, ``pack``, ``unpack``, ``run --check`` and
``run <packed spec>`` raise ``NotImplementedError`` until their modules
are ported (ROADMAP queue 1, the control plane).
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_plan(args) -> None:
    from repro_torch.core import ResourceIntent, plan

    intent = ResourceIntent(
        arch=args.arch, shape=args.shape, goal=args.goal,
        budget_usd_per_hour=args.budget,
        chip_generation=args.chip,
        min_chips=args.min_chips, max_chips=args.max_chips,
        allow_multi_pod=not args.no_multi_pod,
        slice_name=args.slice,
        mesh_shape=tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None,
    )
    choices = plan(intent, top_k=args.top_k)
    if not choices:
        print("no feasible plan under the given constraints")
        sys.exit(1)
    print(f"intent: {intent}")
    print(f"top {len(choices)} plans ({args.goal}):")
    for i, c in enumerate(choices):
        print(f"  #{i+1} {c.summary}")


CONTROL_PLANE = "ROADMAP queue 1, the control plane"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {CONTROL_PLANE}")


def cmd_explore(args) -> None:
    _not_ported("the cost-performance explorer (`explore`)")


def cmd_calibrate(args) -> None:
    _not_ported("harvesting and fitting a calibration (`calibrate`)")


def cmd_check(args) -> None:
    _not_ported("the static workflow checker (`check`)")


def cmd_pack(args) -> None:
    _not_ported("packed workflow artifacts (`pack`)")


def cmd_unpack(args) -> None:
    _not_ported("packed workflow artifacts (`unpack`)")


def _looks_like_spec_path(target: str) -> bool:
    import os

    return (target.endswith((".json", ".yaml", ".yml"))
            or os.path.sep in target or os.path.exists(target))


def _load_run_target(args):
    """(template, graph, params) for `run`: a registry template name (a
    path to a packed workflow artifact is not ported yet)."""
    from repro_torch.core import REGISTRY

    if _looks_like_spec_path(args.template):
        _not_ported(f"running a packed workflow spec ({args.template})")
    return REGISTRY.get(args.template, args.version), None, {}


def cmd_run(args) -> None:
    from repro_torch.core import ProvenanceStore, StageCache, run_workflow
    from repro_torch.ft.failures import RestartPolicy

    t, graph, params = _load_run_target(args)
    if args.steps is None and params.get("steps_override") is not None:
        args.steps = int(params["steps_override"])
    if args.override:
        overrides = {}
        for kv in args.override:
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            overrides[k] = v
        t = t.with_overrides(**overrides)
    store = ProvenanceStore(args.runs_dir)
    cache = None if args.no_cache else StageCache(args.cache_dir,
                                                  max_bytes=args.cache_max_bytes)
    retry = None
    if args.stage_retries:
        retry = RestartPolicy(max_restarts=args.stage_retries,
                              backoff_s=args.stage_backoff)
    res = run_workflow(t, store, user=args.user, workspace=args.workspace,
                       steps_override=args.steps,
                       stages=args.stage or None,
                       with_eval=args.with_eval,
                       cache=cache,
                       serve_engine=args.serve_engine,
                       serve_chunk=args.serve_chunk,
                       serve_spec_k=args.serve_spec_k,
                       serve_draft=args.serve_draft,
                       donate=not args.no_donate,
                       stage_retry=retry,
                       resume=args.resume,
                       resume_store=not args.no_run_manifest,
                       graph=graph,
                       check=args.check,
                       executor=args.executor,
                       workers=args.workers,
                       device=args.device)
    print(f"run {res.record.run_id}: ok={res.ok}")
    for name, sr in res.stage_results.items():
        status = "ok" if sr.ok else "FAIL"
        if sr.cached:
            status = "skip" if sr.resumed else "hit"
        extra = f" x{sr.attempts}" if sr.attempts > 1 else ""
        where = f"  @ {sr.placement}" if sr.placement else ""
        print(f"  stage {name:16s} {status:4s} "
              f"{sr.duration_s:7.2f}s{extra}{where}")
    for name, (ok, detail) in res.checks.items():
        print(f"  check {name:20s} {'PASS' if ok else 'FAIL'}  {detail}")
    if res.plan_choice:
        print(f"  plan: {res.plan_choice.summary}")


def cmd_graph(args) -> None:
    from repro_torch.core import REGISTRY, compile_template, resolve_placements

    t = REGISTRY.get(args.template, args.version)
    g = compile_template(t, with_eval=args.with_eval)
    if args.stage:
        g = g.subgraph(args.stage)
    placements = resolve_placements(t, g) if args.placements else None
    print(g.render(placements=placements))


def cmd_catalog(args) -> None:
    from repro_torch.core import CATALOG, catalog_summary

    print(json.dumps(catalog_summary(), indent=1))
    for s in CATALOG:
        print(f"  {s.name:>14s} chips={s.total_chips:5d} "
              f"pods={s.num_pods} ${s.price_per_hour:9.2f}/h")


def cmd_templates(args) -> None:
    from repro_torch.core import REGISTRY

    for name, version, desc in REGISTRY.list():
        print(f"  {name:28s} v{version:8s} {desc}")


def cmd_runs(args) -> None:
    from repro_torch.core import ProvenanceStore

    store = ProvenanceStore(args.runs_dir)
    for run_id in store.list_runs():
        rec = store.load(run_id)
        hist = rec.metrics()
        last = hist[-1] if hist else {}
        print(f"  {run_id:48s} steps={len(hist):4d} "
              f"loss={last.get('loss', float('nan')):.4f}")


def cmd_compare(args) -> None:
    from repro_torch.core import ProvenanceStore

    store = ProvenanceStore(args.runs_dir)
    print(json.dumps(store.compare(args.run_a, args.run_b), indent=1, default=str))


def cmd_cache(args) -> None:
    from repro_torch.core import StageCache

    cache = StageCache(args.cache_dir)
    if args.action == "clear":
        n = cache.clear()
        print(f"cleared {n} cached stage outputs from {cache.root}")
        return
    stats = cache.stats()
    print(json.dumps(stats, indent=1))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="intent -> ranked execution plans")
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--goal", default="production",
                   choices=["production", "quick_test", "exploration"])
    p.add_argument("--budget", type=float, default=None, help="$ per hour cap")
    p.add_argument("--chip", default=None, choices=["v4", "v5e", "v5p"])
    p.add_argument("--min-chips", type=int, default=None)
    p.add_argument("--max-chips", type=int, default=None)
    p.add_argument("--no-multi-pod", action="store_true")
    p.add_argument("--slice", default=None, help="expert override: slice name")
    p.add_argument("--mesh", default=None, help="expert override: e.g. 16,16")
    p.add_argument("--top-k", type=int, default=5)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("explore", help="cost-performance sweep (not ported yet)")
    p.set_defaults(fn=cmd_explore, not_ported=True)

    p = sub.add_parser("calibrate", help="refit the cost model from telemetry (not ported yet)")
    p.set_defaults(fn=cmd_calibrate, not_ported=True)

    p = sub.add_parser("run", help="run a workflow template or packed "
                                   "artifact")
    p.add_argument("template",
                   help="registry template name, or path to a packed "
                        "workflow artifact (see `pack`)")
    p.add_argument("--version", default=None)
    p.add_argument("--check", action="store_true",
                   help="pre-flight static check (not ported yet: raises)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--override", action="append", default=[],
                   help="param injection, e.g. optimizer.lr=0.001")
    p.add_argument("--user", default="anonymous")
    p.add_argument("--workspace", default="default")
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--stage", action="append", default=[],
                   help="run only this stage (+ its ancestors); repeatable")
    p.add_argument("--with-eval", action="store_true",
                   help="include the held-out EvalStage in the graph")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the cross-run stage cache")
    p.add_argument("--cache-dir", default=None,
                   help="stage-cache root (default $REPRO_CACHE_DIR "
                        "or .repro_cache/stages)")
    p.add_argument("--cache-max-bytes", type=int, default=None,
                   help="LRU bound for the stage cache (default "
                        "$REPRO_CACHE_MAX_BYTES or unbounded)")
    p.add_argument("--serve-engine", default="fused",
                   choices=["fused", "legacy", "paged"],
                   help="serving path: fused on-device sampling, the "
                        "per-slot legacy baseline, or the paged KV cache "
                        "(prefix sharing, memory proportional to live "
                        "tokens)")
    p.add_argument("--serve-chunk", type=int, default=1,
                   help="decode this many tokens per serving dispatch "
                        "(1 = step-by-step)")
    p.add_argument("--serve-spec-k", type=int, default=0,
                   help="speculative drafts per verify round (0 = off; "
                        "lossless draft/verify, see docs/serving.md)")
    p.add_argument("--serve-draft", default="",
                   help="draft model arch for speculative decoding "
                        "(same vocab; empty = n-gram proposer)")
    p.add_argument("--no-donate", action="store_true",
                   help="disable train-state buffer donation")
    p.add_argument("--stage-retries", type=int, default=0,
                   help="retry a stage this many times on retryable "
                        "failures (node loss / preemption)")
    p.add_argument("--stage-backoff", type=float, default=0.5,
                   help="base seconds for capped exponential backoff "
                        "between stage retries")
    p.add_argument("--resume", default=None, metavar="RUN_ID",
                   help="resume an interrupted run: skip stages whose "
                        "recorded input hash still matches, restore the "
                        "rest from checkpoints")
    p.add_argument("--no-run-manifest", action="store_true",
                   help="skip writing the per-run stage manifest (the "
                        "run cannot be resumed, but saves per-stage "
                        "output pickling)")
    p.add_argument("--executor", default=None,
                   choices=["threads", "processes", "workers"],
                   help="execution substrate for stage bodies (see "
                        "docs/executors.md): threads = inline on the "
                        "scheduler pool (default), processes = "
                        "process-pool children for process-safe stages "
                        "(escapes the GIL), workers = local worker-queue "
                        "fleet with leases + heartbeat reaping")
    p.add_argument("--workers", type=int, default=None,
                   help="executor worker count (pool children / queue "
                        "workers / thread width); default is "
                        "backend-specific")
    p.add_argument("--device", default="cuda",
                   help="torch device of the workload stages; the default "
                        "needs a GPU")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("graph", help="render a template's stage DAG")
    p.add_argument("template")
    p.add_argument("--version", default=None)
    p.add_argument("--with-eval", action="store_true",
                   help="include the held-out EvalStage in the graph")
    p.add_argument("--stage", action="append", default=[],
                   help="restrict to this stage (+ ancestors); repeatable")
    p.add_argument("--placements", action="store_true",
                   help="also resolve and render each stage's backend "
                        "(slice + mesh) via the planner")
    p.set_defaults(fn=cmd_graph)

    for name, helptext in (("check", "static workflow checker"),
                           ("pack", "bundle a workflow into an artifact"),
                           ("unpack", "explode a packed artifact")):
        p = sub.add_parser(name, help=f"{helptext} (not ported yet)")
        p.set_defaults(fn=globals()[f"cmd_{name}"], not_ported=True)

    p = sub.add_parser("catalog", help="list slice types")
    p.set_defaults(fn=cmd_catalog)

    p = sub.add_parser("templates", help="list workflow templates")
    p.set_defaults(fn=cmd_templates)

    p = sub.add_parser("runs", help="list recorded runs")
    p.add_argument("--runs-dir", default="runs")
    p.set_defaults(fn=cmd_runs)

    p = sub.add_parser("compare", help="diff two runs (config + metrics)")
    p.add_argument("run_a")
    p.add_argument("run_b")
    p.add_argument("--runs-dir", default="runs")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("cache", help="inspect or clear the stage cache")
    p.add_argument("action", choices=["stats", "clear"])
    p.add_argument("--cache-dir", default=None,
                   help="stage-cache root (default $REPRO_CACHE_DIR "
                        "or .repro_cache/stages)")
    p.set_defaults(fn=cmd_cache)
    return ap


def main() -> None:
    ap = build_parser()
    # a command that is not ported takes any flags of the reference's
    # and raises, whatever they are
    args, extra = ap.parse_known_args()
    if extra and not getattr(args, "not_ported", False):
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    args.fn(args)


if __name__ == "__main__":
    main()
