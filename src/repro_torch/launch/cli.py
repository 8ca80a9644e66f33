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

    # plan for the H100: naming the card registers its slices (h100-1,
    # h100-8); nothing else puts the card in the catalog
    python -m repro_torch.launch.cli plan --arch qwen2-1.5b \
        --shape train_4k --chip h100

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

    # static pre-execution checking (ADV001..ADV011) and the run gate
    python -m repro_torch.launch.cli check train-qwen2-1.5b
    python -m repro_torch.launch.cli check --all-templates
    python -m repro_torch.launch.cli run train-qwen2-1.5b --check --steps 20

    # shareable workflow artifacts (the reference's format: either
    # package reads the other's)
    python -m repro_torch.launch.cli pack train-qwen2-1.5b --param steps_override=5
    python -m repro_torch.launch.cli run train-qwen2-1.5b.pack.json --device cpu
    python -m repro_torch.launch.cli unpack train-qwen2-1.5b.pack.json --out-dir specs

    # calibrate from runs on the card (a run counts only if it ran on
    # the card its plan names), then explore the card's slices under it
    python -m repro_torch.launch.cli calibrate --runs-dir runs
    python -m repro_torch.launch.cli explore --arch qwen2-1.5b \
        --shape train_4k --chip h100 --chips 1,8 --global-batch 2,4 \
        --calibration .repro_cache/repro_torch/calibration.json

Every command and flag of the reference's CLI is here.
"""
from __future__ import annotations

import argparse
import json
import sys

# every chip generation the planner takes: the reference's TPUs and the card
CHIP_CHOICES = ["v4", "v5e", "v5p", "h100"]


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


def _csv_ints(raw):
    # argparse type= hook: a ValueError here surfaces as a clean
    # "invalid value" usage error instead of a traceback
    return tuple(int(x) for x in raw.split(",") if x.strip()) if raw else ()


def cmd_explore(args) -> None:
    import json
    import os

    from repro_torch.core import ProvenanceStore, StageCache, calibrate
    from repro_torch.core.explore import (
        ExploreSpec,
        compare_markdown,
        explore,
        frontier_table,
        report_markdown,
        result_doc,
        spec_from_doc,
    )

    if args.calibration:
        cal = calibrate.CalibrationStore(args.calibration).calibration()
        calibrate.activate(cal)
        print(f"calibration generation {cal.generation} "
              f"({len(cal.cells)} cells) active")

    old_doc = None
    if args.compare:
        # re-run the baseline run's exact grid under the current
        # catalog + calibration; the diff below is the deliverable
        base = os.path.join(args.runs_dir, args.compare, "explore.json")
        try:
            with open(base) as f:
                old_doc = json.load(f)
        except OSError as e:
            raise SystemExit(
                f"--compare: cannot read {base} ({e}); the baseline run "
                f"must have been recorded by `explore` (not --no-report)")
        spec = spec_from_doc(old_doc)
    else:
        if not args.arch:
            raise SystemExit("explore: --arch is required "
                             "(unless --compare RUN_ID)")
        spec = ExploreSpec(
            archs=tuple(args.arch),
            shapes=tuple(args.shape or ["train_4k"]),
            goals=tuple(args.goal or ["production"]),
            chip_counts=args.chips,
            global_batches=args.global_batch,
            budget_usd_per_hour=args.budget,
            max_step_seconds=(args.deadline_ms / 1e3
                              if args.deadline_ms else None),
            chip_generation=args.chip,
            allow_multi_pod=not args.no_multi_pod,
            top_k=args.top_k,
            steps=args.steps,
            preempt_rate_per_chip_hour=args.preempt_rate,
            max_restarts=args.max_restarts,
            backoff_s=args.backoff,
        )
    cache = StageCache(args.cache_dir) if args.cache_dir else None
    result = explore(spec, cache=cache, engine=args.engine)
    new_doc = result_doc(result)

    print(f"explored {len(result.cells)} cells "
          f"({result.feasible_cells} feasible, "
          f"{result.cells_from_cache} from cache); "
          f"frontier has {len(result.frontier)} plans")
    print(frontier_table(result))

    compare_report = None
    if old_doc is not None:
        compare_report = compare_markdown(old_doc, new_doc)
        print()
        print(compare_report)

    if not args.no_report:
        import dataclasses as _dc

        store = ProvenanceStore(args.runs_dir)
        rec = store.create_run(
            template="explore", template_version="1",
            config={"spec": _dc.asdict(spec)},
            plan={},
        )
        path = os.path.join(rec.dir, "explore.md")
        with open(path, "w", encoding="utf-8") as f:
            f.write(report_markdown(result))
        with open(os.path.join(rec.dir, "explore.json"), "w",
                  encoding="utf-8") as f:
            json.dump(new_doc, f, indent=2, sort_keys=True)
        if compare_report is not None:
            with open(os.path.join(rec.dir, "compare.md"), "w",
                      encoding="utf-8") as f:
                f.write(compare_report)
        rec.log_event("explore", {
            "cells": len(result.cells),
            "feasible_cells": result.feasible_cells,
            "frontier_size": len(result.frontier),
            "catalog_generation": result.catalog_generation,
            "compared_to": args.compare or None,
            "report": path,
        })
        print(f"report: {path}")


def cmd_calibrate(args) -> None:
    from repro_torch.core import calibrate

    store = calibrate.CalibrationStore(args.store)
    if args.clear:
        store.clear()
        print(f"cleared {store.path}")
        return

    samples = []
    if args.runs_dir:
        samples.extend(calibrate.harvest_runs_dir(args.runs_dir))
    for path in args.bench or ():
        samples.extend(calibrate.harvest_bench(path))
    added = store.ingest(samples)
    print(f"harvested {len(samples)} samples ({added} new) "
          f"-> {store.path}")

    if args.no_fit:
        cal = store.calibration()
    else:
        cal = store.fit(min_samples=args.min_samples)
    print(f"calibration generation {cal.generation}: "
          f"{len(cal.cells)} fitted cells")
    for c in cal.cells:
        print(f"  {c.chip}/{c.kind}: mode={c.mode} "
              f"a_c={c.a_compute:.4f} a_m={c.a_memory:.4f} "
              f"a_x={c.a_collective:.4f} b={c.intercept:.2e} "
              f"scale={c.scale:.4f} n={c.n_samples} "
              f"resid={c.residual:.3e}")

    drift = store.drift(threshold=args.drift_threshold, calibration=cal)
    print(drift.summary())
    if drift.drifted:
        raise SystemExit(2)


def _looks_like_spec_path(target: str) -> bool:
    import os

    return (target.endswith((".json", ".yaml", ".yml"))
            or os.path.sep in target or os.path.exists(target))


def _load_run_target(args):
    """(template, graph, params) for `run`: a registry template name, or
    a path to a packed workflow artifact (kind: package)."""
    from repro_torch.core import REGISTRY, SpecError, load_workflow

    if _looks_like_spec_path(args.template):
        t, graph, params, _ = load_workflow(args.template, strict=True)
        if t is None:
            raise SpecError(
                f"{args.template}: workflow-kind specs carry no template; "
                f"`run` needs a package artifact (see `pack`)")
        return t, graph, params
    return REGISTRY.get(args.template, args.version), None, {}


def cmd_run(args) -> None:
    from repro_torch.core import ProvenanceStore, StageCache, run_workflow
    from repro_torch.core.check import CheckError
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
    try:
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
    except CheckError as e:
        print(e.report.render())
        print("pre-flight check failed; nothing was provisioned or run")
        sys.exit(1)
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


def cmd_check(args) -> None:
    from repro_torch.core import REGISTRY, load_spec, pack_template
    from repro_torch.core.check import check_spec

    def _doc_for(target):
        if _looks_like_spec_path(target):
            return load_spec(target)
        # template names check as their package (the template block is
        # what gives the checker an intent for placement/planner passes)
        return pack_template(REGISTRY.get(target, args.version),
                             with_eval=args.with_eval)

    if args.all_templates:
        names = sorted({n for n, _, _ in REGISTRY.list()})
    elif args.target:
        names = [args.target]
    else:
        print("check: give a template name / spec path, "
              "or --all-templates", file=sys.stderr)
        sys.exit(2)

    reports = []
    for target in names:
        report = check_spec(_doc_for(target),
                            targets=args.stage or None,
                            steps=args.steps,
                            budget_usd=args.budget_usd)
        reports.append(report)
        if args.json:
            print(json.dumps(report.as_doc(), indent=1))
        else:
            print(report.render())
    if args.lowered_out:
        _write_lowered(names[0], _doc_for(names[0]), args.lowered_out)
    if not all(r.ok for r in reports):
        sys.exit(1)


def _write_lowered(target, doc, out_path) -> None:
    """The ADV005 fix, applied: rebuild the checked workflow with
    movement stages inserted and write it back out as a spec."""
    from repro_torch.core import dump_spec, from_spec, to_spec, unpack_package
    from repro_torch.core.check import insert_movement_stages

    template, wf_doc = None, doc
    if doc.get("kind") == "package":
        template, wf_doc, _ = unpack_package(doc)
    graph = from_spec(wf_doc, strict=False)
    lowered = insert_movement_stages(graph, template=template)
    dump_spec(to_spec(lowered, name=wf_doc.get("name"),
                      results=wf_doc.get("results"),
                      external_inputs=wf_doc.get("external_inputs", ()),
                      budget_usd=wf_doc.get("budget_usd")), out_path)
    moves = len(lowered.stages) - len(graph.stages)
    print(f"lowered {target}: inserted {moves} movement stage(s) "
          f"-> {out_path}")


def cmd_pack(args) -> None:
    import os

    from repro_torch.core import REGISTRY, dump_spec, pack_template

    t = REGISTRY.get(args.template, args.version)
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
    params = {}
    for kv in args.param:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        params[k] = v
    out = args.out or f"{t.name}.pack.json"
    if os.path.exists(out) and not args.force:
        print(f"{out} exists; use --force to overwrite", file=sys.stderr)
        sys.exit(1)
    doc = pack_template(t, with_eval=args.with_eval, params=params)
    dump_spec(doc, out)
    print(f"packed {t.name} v{t.version} "
          f"({len(doc['workflow']['stages'])} stages"
          f"{', ' + str(len(params)) + ' param(s)' if params else ''}) "
          f"-> {out}")


def cmd_unpack(args) -> None:
    import os

    from repro_torch.core import dump_spec, load_spec, unpack_package

    doc = load_spec(args.artifact)
    template, wf_doc, params = unpack_package(doc)
    os.makedirs(args.out_dir, exist_ok=True)
    name = doc.get("name", "workflow")
    wf_path = os.path.join(args.out_dir, f"{name}.workflow.json")
    dump_spec(wf_doc, wf_path)
    print(f"workflow -> {wf_path} ({len(wf_doc['stages'])} stages)")
    if template is not None:
        if args.register:
            from repro_torch.core import REGISTRY

            REGISTRY.register(template)
            print(f"registered template {template.name} v{template.version}")
        print(f"template: {template.name} v{template.version} "
              f"({template.kind}, arch={template.arch})")
    if params:
        print(f"params: {json.dumps(params, sort_keys=True)}")


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
    p.add_argument("--chip", default=None, choices=CHIP_CHOICES,
                   help="restrict to one chip generation (h100 registers "
                        "the card's slices)")
    p.add_argument("--min-chips", type=int, default=None)
    p.add_argument("--max-chips", type=int, default=None)
    p.add_argument("--no-multi-pod", action="store_true")
    p.add_argument("--slice", default=None,
                   help="expert override: slice name (h100-1 or h100-8 "
                        "registers the card's slices)")
    p.add_argument("--mesh", default=None, help="expert override: e.g. 16,16")
    p.add_argument("--top-k", type=int, default=5)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("explore",
                       help="cost-performance sweep: Pareto frontier, "
                            "scaling report, retry-aware expected cost")
    p.add_argument("--arch", action="append", default=None,
                   help="architecture to sweep; repeatable (required "
                        "unless --compare)")
    p.add_argument("--shape", action="append", default=None,
                   help="workload shape(s); repeatable (default train_4k)")
    p.add_argument("--goal", action="append", default=None,
                   choices=["production", "quick_test", "exploration"],
                   help="intent goal(s); repeatable (default production)")
    p.add_argument("--chips", type=_csv_ints, default=(),
                   help="chip-count axis, e.g. 8,16,32,64 "
                        "(default: planner free choice)")
    p.add_argument("--global-batch", type=_csv_ints, default=(),
                   help="global-batch axis, e.g. 128,256,512 "
                        "(default: the shape's own)")
    p.add_argument("--budget", type=float, default=None,
                   help="$ per hour cap for every cell")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="max step time for every cell")
    p.add_argument("--chip", default=None, choices=CHIP_CHOICES,
                   help="restrict the sweep to one chip generation (h100 "
                        "registers the card's slices)")
    p.add_argument("--no-multi-pod", action="store_true")
    p.add_argument("--top-k", type=int, default=3,
                   help="ranked plans kept per grid cell")
    p.add_argument("--steps", type=int, default=1000,
                   help="projection horizon for the expected-cost column")
    p.add_argument("--preempt-rate", type=float, default=0.0,
                   help="preemptions per chip-hour for the retry-aware "
                        "expected cost (0 = reliable fleet)")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="restart budget folded into the cost projection")
    p.add_argument("--backoff", type=float, default=30.0,
                   help="base seconds of restart backoff in the projection")
    p.add_argument("--engine", default="vectorized",
                   choices=["vectorized", "scalar"],
                   help="planner engine (scalar = the parity oracle)")
    p.add_argument("--cache-dir", default=None,
                   help="StageCache root for per-cell reuse across sweeps")
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--no-report", action="store_true",
                   help="print the frontier only; skip the "
                        "runs/<id>/explore.md report artifact")
    p.add_argument("--compare", default=None, metavar="RUN_ID",
                   help="re-run RUN_ID's recorded grid under the current "
                        "catalog + calibration and print/record a "
                        "byte-deterministic per-cell diff (compare.md)")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="activate the fitted coefficients from this "
                        "calibration store for the sweep")
    p.set_defaults(fn=cmd_explore)

    p = sub.add_parser("calibrate",
                       help="harvest run/bench telemetry into the "
                            "calibration store, refit the cost model, "
                            "report drift (exit 2 on drift)")
    p.add_argument("--store", default=None,
                   help="calibration store path (default "
                        ".repro_cache/repro_torch/calibration.json or "
                        "$REPRO_CALIBRATION_PATH)")
    p.add_argument("--runs-dir", default=None,
                   help="provenance root to harvest finished runs from "
                        "(a run counts only if it ran on the card its "
                        "plan names)")
    p.add_argument("--bench", action="append", default=None,
                   metavar="PATH",
                   help="BENCH_*.json file carrying calibration_samples; "
                        "repeatable")
    p.add_argument("--min-samples", type=int, default=4,
                   help="observations required per (chip, kind) cell "
                        "for the full linear fit (fewer -> scale mode)")
    p.add_argument("--drift-threshold", type=float, default=0.25,
                   help="relative predicted-vs-measured error that "
                        "flags a cell as drifted")
    p.add_argument("--no-fit", action="store_true",
                   help="ingest only; keep the stored coefficients")
    p.add_argument("--clear", action="store_true",
                   help="empty the store (samples and cells)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("run", help="run a workflow template or packed "
                                   "artifact")
    p.add_argument("template",
                   help="registry template name, or path to a packed "
                        "workflow artifact (see `pack`)")
    p.add_argument("--version", default=None)
    p.add_argument("--check", action="store_true",
                   help="pre-flight static check (see `check`); abort "
                        "before provisioning on any error diagnostic")
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

    p = sub.add_parser("check", help="static pre-execution workflow "
                                     "checker (diagnostic codes ADV001+)")
    p.add_argument("target", nargs="?", default=None,
                   help="template name, or path to a workflow/package "
                        "spec (.json/.yaml)")
    p.add_argument("--version", default=None,
                   help="template version (names only)")
    p.add_argument("--with-eval", action="store_true",
                   help="check the template graph with the EvalStage "
                        "included")
    p.add_argument("--all-templates", action="store_true",
                   help="check every registered template (CI smoke)")
    p.add_argument("--stage", action="append", default=[],
                   help="check the `run --stage` subgraph of these "
                        "targets; repeatable")
    p.add_argument("--steps", type=int, default=None,
                   help="projection horizon for the budget check "
                        "(ADV007); default: the template's num_steps")
    p.add_argument("--budget-usd", type=float, default=None,
                   help="budget envelope for ADV007 (overrides the "
                        "spec's budget_usd)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON instead of text")
    p.add_argument("--lowered-out", default=None, metavar="PATH",
                   help="also write the movement-lowered workflow spec "
                        "(the ADV005 fix) to PATH")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("pack", help="bundle a template + workflow + "
                                    "params into one shareable artifact")
    p.add_argument("template")
    p.add_argument("--version", default=None)
    p.add_argument("--with-eval", action="store_true",
                   help="include the held-out EvalStage in the packed "
                        "graph")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default <template>.pack.json)")
    p.add_argument("--param", action="append", default=[],
                   help="run param default baked into the artifact, "
                        "e.g. steps_override=5; repeatable")
    p.add_argument("--override", action="append", default=[],
                   help="template param injection before packing, "
                        "e.g. optimizer.lr=0.001; repeatable")
    p.add_argument("--force", action="store_true",
                   help="overwrite an existing output file")
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("unpack", help="explode a packed artifact into "
                                      "its workflow spec + template")
    p.add_argument("artifact", help="path to a .pack.json artifact")
    p.add_argument("--out-dir", default=".",
                   help="directory for the extracted workflow spec")
    p.add_argument("--register", action="store_true",
                   help="also register the carried template in this "
                        "process's registry")
    p.set_defaults(fn=cmd_unpack)

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
    args = build_parser().parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
