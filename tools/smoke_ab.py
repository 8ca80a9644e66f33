"""Run parts of ``chip_smoke.py`` for several trees in turns on one card,
to tell a change's effect from the card's: each tree in a subprocess
from its own root (its own ``src`` and kernel build), in the order given.

    python3 tools/smoke_ab.py --alone TREE_A TREE_B TREE_B TREE_A
    python3 tools/smoke_ab.py --upto-31 TREE_A TREE_B

``--alone`` runs phase 5 (paged serving) and phases 29-31 (the train
workflow at global batch 2 and 4 planned for the card, and the
calibration whose residual phase 31 bounds) after the device and build
phases, nothing else; ``--upto-31`` runs the tree's whole ``main()`` and
stops where phase 32 would start.  A tree is a directory holding a
checkout (``git archive <commit> | tar -x -C TREE``).  Prints, per tree,
the lines of phases 5, 10, 30 and 31 and whether the calibration held.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

ALONE = r'''
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_device()
cs.phase_build()
cfg = cs.get_config("qwen2-1.5b")
model = cs.build_model(cfg)
params = model.serving_params(model.init(seed=0))
cs.phase_serve_paged(model, params, cfg)
del model, params
torch.cuda.empty_cache()
cs.phase_card_catalog()
with tempfile.TemporaryDirectory() as runs:
    card, card_runs = cs.phase_card_train_workflow(runs)
    try:
        cs.phase_card_calibrate_explore(runs, card_runs)
        print("CALIBRATE PASSED", flush=True)
    except AssertionError as e:
        print("CALIBRATE FAILED", e, flush=True)
'''

UPTO_31 = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
def stop(*a, **k):
    print("STOP after phase 31", flush=True)
    sys.exit(0)
cs.phase_slice_kernels = stop
sys.exit(cs.main())
'''

KEEP = ("[1 device]", "[2 build]", "[5 serve paged] warm", "[10 train] losses",
        "[30 card train workflow]   step", "[31 card calibrate] harvested",
        "CALIBRATE", "STOP")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--alone", action="store_true")
    mode.add_argument("--upto-31", action="store_true")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    code = ALONE if args.alone else UPTO_31
    for tree in args.trees:
        print(f"===== {tree}", flush=True)
        r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
        for line in r.stdout.splitlines():
            if line.startswith(KEEP):
                print(line[:400], flush=True)
        print("rc", r.returncode, r.stderr[-1500:] if r.returncode else "",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
