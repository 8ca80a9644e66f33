"""Multi-pod dry-run of the port.

For every live (architecture × input-shape) cell, run the port's step
once on fake tensors of one rank's blocks over a fake world of 256 ranks
(the single-pod 16×16 mesh) AND of 512 ranks (the 2×16×16 multi-pod
mesh), and record that rank's memory, FLOPs, bytes and collective
traffic (``launch/cells.py``, ``launch/op_stats.py``).  Results
accumulate in a JSON artifact (default ``dryrun_results.json``) under
``tag|arch|shape|mesh`` keys, the reference's layout; a cell already
``ok`` there is reused unless ``--force``.  Each cell's op record is
saved gzipped under ``--hlo-dir`` (the reference saves its HLO there)
for ``launch/reanalyze.py``.

Runs on a machine without a GPU: nothing here touches CUDA.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import all_cells, get_config
from repro_torch.launch.cells import build_cell, count_cell, default_plan
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import OptimizerConfig


def record_path(hlo_dir: str, key: str) -> str:
    return os.path.join(hlo_dir, key.replace("|", "__").replace("/", "_")
                        + ".ops.json.gz")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             plan_kw: Optional[dict] = None,
             moment_dtype: str = "float32",
             hlo_dir: Optional[str] = None,
             key: str = "", mesh=None) -> Dict:
    """One cell's record (``mesh`` replaces the production mesh)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    plan = default_plan(get_config(arch), mesh, **(plan_kw or {}))
    opt_cfg = OptimizerConfig(moment_dtype=moment_dtype)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, plan, opt_cfg)
    t_lower = time.time() - t0
    stats, ops = count_cell(cell)
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
        with gzip.open(record_path(hlo_dir, key), "wt") as f:
            json.dump(ops, f)
    trace_s = stats.pop("trace_s")
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": cell.mesh_desc,
        "multi_pod": multi_pod,
        "kind": cell.kind,
        "plan": {
            "remat": cell.plan.remat,
            "microbatch": cell.plan.microbatch,
            "fsdp": cell.plan.fsdp,
            "attn_impl": cell.plan.attn_impl,
            "seq_shard_attn": cell.plan.seq_shard_attn,
            "moment_dtype": moment_dtype,
            "dp_axes": list(cell.plan.dp_axes),
            "logical": {k: str(v) for k, v in cell.plan.logical.items()},
        },
        "lower_s": round(t_lower, 2),
        # the fake step's wall time, where the reference times XLA's
        # compile
        "compile_s": round(trace_s, 2),
        **stats,
        "ok": True,
    }
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--attn-impl", default="xla", choices=["xla", "tri"])
    ap.add_argument("--seq-shard-attn", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--tag", default="baseline", help="result-set tag")
    ap.add_argument("--hlo-dir", default="hlo_artifacts",
                    help="save each cell's gzipped op record ('' = off)")
    args = ap.parse_args(argv)

    results: Dict[str, Dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    cells = [
        (a, s) for a, s, ok, _ in all_cells()
        if ok and (args.arch is None or a == args.arch)
        and (args.shape is None or s == args.shape)
    ]
    skips = [(a, s, why) for a, s, ok, why in all_cells() if not ok]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    print(f"dry-run: {len(cells)} live cells × {len(meshes)} meshes "
          f"({len(skips)} documented skips), fake worlds of "
          f"{' and '.join('512' if m else '256' for m in meshes)} ranks")

    plan_kw = {"remat": args.remat, "microbatch": args.microbatch,
               "attn_impl": args.attn_impl,
               "seq_shard_attn": args.seq_shard_attn,
               "compress_grads": args.compress_grads}
    n_done = n_fail = 0
    # one fake world at a time: every cell of a mesh, then the next mesh
    for mp in meshes:
        for arch, shape in cells:
            key = f"{args.tag}|{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
            if key in results and results[key].get("ok") and not args.force:
                print(f"[cache] {key}")
                continue
            print(f"[run  ] {key} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp, plan_kw, args.moment_dtype,
                               args.hlo_dir or None, key)
                rec["tag"] = args.tag
                results[key] = rec
                n_done += 1
                mem_gb = rec.get("temp_size_in_bytes", 0) / 1e9
                arg_gb = rec.get("argument_size_in_bytes", 0) / 1e9
                print(
                    f"        ok: trace={rec['compile_s']:.1f}s "
                    f"flops={rec.get('flops', 0):.3e} "
                    f"args={arg_gb:.2f}GB temp={mem_gb:.2f}GB "
                    f"coll={rec['collectives']['total_operand_bytes']/1e9:.2f}GB/dev "
                    f"({rec['collectives']['total_ops']} ops)", flush=True)
            except Exception as e:
                n_fail += 1
                results[key] = {
                    "arch": arch, "shape": shape, "tag": args.tag,
                    "multi_pod": mp, "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                }
                print(f"        FAIL: {type(e).__name__}: {e}")
                if not isinstance(e, NotImplementedError):
                    traceback.print_exc(limit=3)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    results["_skips"] = [
        {"arch": a, "shape": s, "reason": why} for a, s, why in skips
    ]
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"done: {n_done} counted, {n_fail} failed -> {args.out}")


if __name__ == "__main__":
    main()
