"""The spread of ``chip_smoke.py`` phase 30's median steps and phase 31's
fit residual on the card: the tool that shows how far the one-scale
calibration of the card's train cell moves between repetitions, with the
host quiet and with its cores busy.

    PYTHONPATH=src python -m repro_torch.launch.profile_card_fit \\
        [--steps 6 9] [--reps 2]

Each repetition runs phase 30's two train workflows (``train-qwen2-1.5b``
at full width, global batch 2 and 4, planned for the card) at one step
count, harvests both runs and fits them as phase 31 does
(``calibrate.harvest_runs_dir``, ``calibrate.fit_cells``).  First one
warm-up repetition at the first step count (the first workflow in a
process pays its set-up in its first steps), then ``--reps`` repetitions
of each step count with the host quiet, then one of each with one
spinning process a core (stopped after).  Prints chip_smoke's lines of
each run, one JSON row a repetition (the medians beside the uncalibrated
estimates, the scale and the residual, and the bound phase 31 holds it
to), the card's name and power limit, and the rows as JSON.  Needs a CUDA
device; loads ``chip_smoke.py`` from the root of the checkout it lives in.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

from repro_torch.core import calibrate

ROOT = pathlib.Path(__file__).resolve().parents[3]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def repetition(cs, tag: str, steps: int) -> dict:
    with tempfile.TemporaryDirectory() as runs:
        cs.phase_card_train_workflow(runs, steps)
        samples = calibrate.harvest_runs_dir(runs)
    (cell,) = calibrate.fit_cells(samples)
    est = {s.source: float(calibrate.static_step(
        s.compute_s, s.memory_s, s.collective_s)) for s in samples}
    row = dict(tag=tag, steps=steps,
               median_step_s=sorted(s.measured_step_s for s in samples),
               est_step_s=sorted(est.values()), scale=cell.scale,
               residual=cell.residual, bound=cs.CARD_FIT_RESIDUAL)
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[6, 9])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_card_fit needs a CUDA device")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    cs.register_card()
    rows = [repetition(cs, "warm-up", args.steps[0])]
    for i in range(args.reps):
        rows += [repetition(cs, f"quiet {i}", n) for n in args.steps]
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(os.cpu_count() or 1)]
    try:
        rows += [repetition(cs, "busy", n) for n in args.steps]
    finally:
        for p in spin:
            p.kill()
            p.wait()
    cs.unregister_card()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
