"""K6 and K6-bwd on the card: the time of each at the shapes of
``chip_smoke.py`` phase 13, and the backward's device time split by
kernel, beside the card's name and power limit: the tool that times two
trees' mLSTM kernels in one chip call.

    PYTHONPATH=src python -m repro_torch.launch.profile_mlstm

Cases (bf16, random values from seed 0, f_pre shifted by +1 as phase 13
draws them): xlstm-125m's training shape (B 8, H 4, S 4096, D = DV =
384), S = 1000 (B 1) and D = DV = 64 (B 2, S 4096).  A time is the
median over 10 replays of a CUDA graph of 3 calls
(``kernels.timing.time_ms``: no launch overhead).  The split is the
device time of each kernel of K6-bwd, by name, summed over 5 calls
under ``torch.profiler`` and divided by 5.  The path a launch took
(tensor cores or FMAs) is printed where the module counts it.  Prints
one line a case, the card's name and power limit, and the rows as JSON;
needs a CUDA device.  To time another checkout's kernels with this
script, run it by path with that checkout's ``src`` first on
``PYTHONPATH``:

    PYTHONPATH=<other>/src python src/repro_torch/launch/profile_mlstm.py

and alternate the two trees in one call (parent, change, change,
parent).
"""
from __future__ import annotations

import json
import re
import subprocess

import torch

from repro_torch.kernels import mlstm_scan
from repro_torch.kernels.timing import time_ms

CASES = (("train-shape", 8, 4, 4096, 384, 384),
         ("S=1000", 1, 4, 1000, 384, 384),
         ("D=64", 2, 4, 4096, 64, 64))
SEED = 0
REPS, INNER = 10, 3     # graph replays, calls a graph
SPLIT_CALLS = 5


def _inputs(gen, B, H, S, D, DV):
    dev = torch.device("cuda")
    q, k = (torch.randn((B, H, S, D), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    v, dh = (torch.randn((B, H, S, DV), generator=gen, device=dev)
             .bfloat16() for _ in range(2))
    i_pre = torch.randn((B, H, S), generator=gen, device=dev).bfloat16()
    f_pre = (torch.randn((B, H, S), generator=gen, device=dev) + 1).bfloat16()
    return (q, k, v, i_pre, f_pre), dh


def _launch(attr: str, fn):
    """``fn()`` and the path its launch took, by the module's counter of
    tensor-core launches ``attr`` (a tree without it does not count)."""
    before = getattr(mlstm_scan, attr, None)
    out = fn()
    if before is None:
        return out, "not counted"
    return out, ("tensor-cores" if getattr(mlstm_scan, attr) > before
                 else "fma")


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


def profile(name, B, H, S, D, DV, gen):
    xs, dh = _inputs(gen, B, H, S, D, DV)
    (h, m, qn), fwd_path = _launch("tc_launches", lambda: (
        mlstm_scan.mlstm_scan_cuda(*xs, with_stats=True)))
    _, bwd_path = _launch("bwd_tc_launches", lambda: (
        mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn, dh)))
    ms = time_ms(lambda: mlstm_scan.mlstm_scan_cuda(*xs, with_stats=True),
                 REPS, INNER)
    bwd_ms = time_ms(lambda: mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn,
                                                            dh),
                     REPS, INNER)
    split = _split(lambda: mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn, dh))
    print(f"{name} B={B} H={H} S={S} D={D} DV={DV}: K6 {ms:.4f} ms "
          f"({fwd_path}), K6-bwd {bwd_ms:.4f} ms ({bwd_path}); the "
          f"backward by kernel (profiler, ms a call): " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(split.items(),
                                                  key=lambda kv: -kv[1])),
          flush=True)
    return dict(case=name, B=B, H=H, S=S, D=D, DV=DV, ms=ms, bwd_ms=bwd_ms,
                fwd_path=fwd_path, bwd_path=bwd_path, bwd_split=split)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_mlstm needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [profile(*case, gen) for case in CASES]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
