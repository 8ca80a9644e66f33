"""K5 and K5-bwd on the card: the time of each at the shapes of
``chip_smoke.py`` phase 17, and the backward's device time split by
kernel (the walk, the epilogue), beside the card's name and power limit:
the tool that times two trees' selective-scan kernels in one chip call.

    PYTHONPATH=src python -m repro_torch.launch.profile_ssm

Cases (bf16, random values from seed 0, drawn as phase 17 draws them: dt
in [0.01, 0.21], A in [-2.05, -0.05]): hymba-1.5b's training shape (B 2,
S 4096, Din 3200, N 16), batch 1, and a ragged S and Din (B 2, S 1000,
Din 1000).  A time is the median over 10 replays of a CUDA graph of 3
calls (``kernels.timing.time_ms``: no launch overhead).  The split is the
device time of each kernel of K5-bwd, by name, summed over 5 calls under
``torch.profiler`` and divided by 5.  Prints one line a case, the card's
name and power limit, and the rows as JSON; needs a CUDA device.  To time
another checkout's kernels with this script, run it by path with that
checkout's ``src`` first on ``PYTHONPATH``:

    PYTHONPATH=<other>/src python src/repro_torch/launch/profile_ssm.py

and alternate the two trees in one call (parent, change, change,
parent).
"""
from __future__ import annotations

import json
import re
import subprocess

import torch

from repro_torch.kernels import ssm_scan
from repro_torch.kernels.timing import time_ms

CASES = (("train-shape", 2, 4096, 3200, 16),
         ("batch-1", 1, 4096, 3200, 16),
         ("ragged", 2, 1000, 1000, 16))
SEED = 0
REPS, INNER = 10, 3     # graph replays, calls a graph
SPLIT_CALLS = 5


def _inputs(gen, B, S, Din, N):
    dev = torch.device("cuda")
    x = torch.randn((B, S, Din), generator=gen, device=dev).bfloat16()
    dt = (torch.rand((B, S, Din), generator=gen, device=dev) * 0.2
          + 0.01).bfloat16()
    A = -torch.rand((Din, N), generator=gen, device=dev) * 2 - 0.05
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=dev)
              for _ in range(2))
    D = torch.randn((Din,), generator=gen, device=dev)
    dy = torch.randn((B, S, Din), generator=gen, device=dev).bfloat16()
    return (x, dt, A, Bm, Cm, D), dy


def _split(fn):
    """Device ms a call of ``fn`` by kernel name."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(SPLIT_CALLS):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name().replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name.replace("void ", ""))[0]
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e6
    return {k: v / SPLIT_CALLS for k, v in by_name.items()}


def profile(name, B, S, Din, N, gen):
    xs, dy = _inputs(gen, B, S, Din, N)
    _, ckpt = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
    ms = time_ms(lambda: ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True), REPS,
                 INNER)
    bwd_ms = time_ms(lambda: ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy), REPS,
                     INNER)
    split = _split(lambda: ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy))
    print(f"{name} B={B} S={S} Din={Din} N={N}: K5 {ms:.4f} ms, K5-bwd "
          f"{bwd_ms:.4f} ms; the backward by kernel (profiler, ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1])),
          flush=True)
    return dict(case=name, B=B, S=S, Din=Din, N=N, ms=ms, bwd_ms=bwd_ms,
                bwd_split=split)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_ssm needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [profile(*case, gen) for case in CASES]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
