"""Perf-iteration runner: count tagged plan variants of one cell and print
the roofline-term deltas against the baseline tag.

Counterpart of the reference package's ``launch/hillclimb.py``, with
its CLI; the cell is counted by the port's dry-run (``launch/dryrun.py``:
the step on fake tensors over a fake world) instead of compiled, and the
roofline terms default to the card (``--chip h100``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen2-1.5b --shape train_4k --mesh single \\
        --tag mb4 --microbatch 4

Results accumulate in the same ``dryrun_results.json``, tagged.

With ``--calibration PATH`` the model-side estimates (and
:func:`refine_plan`'s scoring) use the fitted coefficients of that
calibration store instead of the static roofline.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_cell


def term_summary(rec, chip="h100"):
    """Roofline time terms of one dryrun record on one chip generation
    (catalog peak rates via :func:`repro_torch.launch.op_stats.
    roofline_terms`)."""
    from repro_torch.launch.op_stats import roofline_terms

    t = roofline_terms(rec.get("hlo_stats", {}), chip)
    c, m, x = t["compute_s"], t["memory_s"], t["collective_s"]
    return {
        "compute_ms": c * 1e3, "memory_ms": m * 1e3, "collective_ms": x * 1e3,
        "step_bound_ms": max(c, m, x) * 1e3,
        "temp_gb": rec.get("temp_size_in_bytes", 0) / 1e9,
    }


def refine_plan(arch, shape, slice_name, *, start=None, max_iters=16):
    """Greedy neighbor search over plan geometry on a fixed slice,
    scored by the (calibration-aware) analytic cost model — the
    reference's, on the port's copies of the planner and the cost model.

    Starts from ``start`` (a PlanGeometry) or the planner's winner for
    the slice, then repeatedly tries single-knob moves — remat level,
    microbatch ×2 / ÷2, gradient compression — keeping any move that
    lowers the estimated step time while staying feasible.

    Returns ``(geometry, estimate, history)`` where ``history`` is one
    dict per accepted move."""
    import dataclasses as _dc

    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.catalog import find_slice
    from repro_torch.core.costmodel import estimate
    from repro_torch.core.intent import ResourceIntent
    from repro_torch.core.planner import plan

    cfg, shp, sl = get_config(arch), get_shape(shape), find_slice(slice_name)
    if start is None:
        choices = plan(ResourceIntent(arch=arch, shape=shape,
                                      goal="production",
                                      slice_name=slice_name), top_k=1)
        if not choices:
            raise ValueError(f"no feasible plan for {arch}/{shape} "
                             f"on {slice_name}")
        start = choices[0].geometry

    def score(geom):
        est = estimate(cfg, shp, sl, geom)
        return (est.step_s if est.feasible else float("inf")), est

    def neighbors(geom):
        for remat in ("none", "dots", "full"):
            if remat != geom.remat:
                yield _dc.replace(geom, remat=remat)
        if geom.microbatch > 1:
            yield _dc.replace(geom, microbatch=geom.microbatch // 2)
        yield _dc.replace(geom, microbatch=geom.microbatch * 2)
        yield _dc.replace(geom, compress_grads=not geom.compress_grads)

    best_geom = start
    best_s, best_est = score(start)
    history = [{"move": "start", "step_s": best_s,
                "geometry": _dc.asdict(start)}]
    for _ in range(max_iters):
        improved = False
        for cand in neighbors(best_geom):
            s, est = score(cand)
            if s < best_s:
                best_geom, best_s, best_est, improved = cand, s, est, True
        if not improved:
            break
        history.append({"move": "accept", "step_s": best_s,
                        "geometry": _dc.asdict(best_geom)})
    return best_geom, best_est, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--baseline-tag", default="baseline")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--hlo-dir", default="hlo_artifacts")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "tri"])
    ap.add_argument("--seq-shard-attn", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--moe-impl", default="scatter", choices=["scatter", "shard_map"])
    ap.add_argument("--flash-bq", type=int, default=512)
    ap.add_argument("--flash-bk", type=int, default=1024)
    ap.add_argument("--chip", default="h100",
                    help="chip generation for the roofline terms")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="calibration store; activates its fitted "
                         "coefficients for the model-side estimates")
    args = ap.parse_args(argv)

    if args.calibration:
        from repro_torch.core import calibrate
        cal = calibrate.CalibrationStore(args.calibration).calibration()
        calibrate.activate(cal)
        print(f"[hillclimb] calibration generation {cal.generation} "
              f"({len(cal.cells)} cells) active", flush=True)

    plan_kw = {"remat": args.remat, "microbatch": args.microbatch,
               "attn_impl": args.attn_impl,
               "seq_shard_attn": args.seq_shard_attn,
               "compress_grads": args.compress_grads,
               "ssm_chunk": args.ssm_chunk,
               "moe_impl": args.moe_impl,
               "flash_block_q": args.flash_bq,
               "flash_block_k": args.flash_bk}
    if args.no_fsdp:
        plan_kw["fsdp"] = False
    mp = args.mesh == "multi"
    mesh_desc = "2x16x16" if mp else "16x16"
    key = f"{args.tag}|{args.arch}|{args.shape}|{mesh_desc}"

    results = {}
    if os.path.exists(args.out):
        results = json.load(open(args.out))

    print(f"[hillclimb] {key} plan={plan_kw}", flush=True)
    rec = run_cell(args.arch, args.shape, mp, plan_kw, args.moment_dtype,
                   args.hlo_dir or None, key)
    rec["tag"] = args.tag
    results[key] = rec
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)

    new = term_summary(rec, args.chip)
    base_key = f"{args.baseline_tag}|{args.arch}|{args.shape}|{mesh_desc}"
    base = results.get(base_key)
    print(f"\n{'term':16s} {'baseline':>12s} {'this':>12s} {'delta':>8s}")
    if base and base.get("ok"):
        old = term_summary(base, args.chip)
        for k in new:
            b, n = old[k], new[k]
            d = (n - b) / b * 100 if b else float("nan")
            print(f"{k:16s} {b:12.2f} {n:12.2f} {d:+7.1f}%")
    else:
        for k, v in new.items():
            print(f"{k:16s} {'-':>12s} {v:12.2f}")
    print(f"compile_s={rec['compile_s']}")


if __name__ == "__main__":
    main()
