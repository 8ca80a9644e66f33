"""Re-run the op-record analyzer over saved dry-run records (no new
trace) and refresh ``hlo_stats`` (and the top-level counts read from
it) in the results JSON, so that analyzer changes apply retroactively.

Counterpart of the reference package's ``launch/reanalyze.py``, which
re-reads saved HLO; the port's dry-run saves each cell's op record
(``launch/dryrun.py``, ``--hlo-dir``) instead.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --out dryrun_results.json
"""
from __future__ import annotations

import argparse
import gzip
import json
import os

from repro_torch.launch.dryrun import record_path
from repro_torch.launch.op_stats import analyze_ops, collectives_summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--hlo-dir", default="hlo_artifacts")
    args = ap.parse_args(argv)
    results = json.load(open(args.out))
    n = 0
    for key, rec in results.items():
        if key.startswith("_") or not isinstance(rec, dict) or not rec.get("ok"):
            continue
        path = record_path(args.hlo_dir, key)
        if not os.path.exists(path):
            continue
        with gzip.open(path, "rt") as f:
            stats = analyze_ops(json.load(f))
        rec["hlo_stats"] = stats
        rec["flops"] = stats["flops"]
        rec["bytes_accessed"] = stats["hbm_bytes"]
        rec["transcendentals"] = stats["transcendentals"]
        rec["collectives"] = collectives_summary(stats)
        n += 1
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"re-analyzed {n} cells")


if __name__ == "__main__":
    main()
