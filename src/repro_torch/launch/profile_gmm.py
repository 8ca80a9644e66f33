"""K4's time on the card at the MoE configs' layer shapes, beside its
bound and cuBLAS's batched GEMM on the same layout: the tool that times
two trees' K4 in one chip call.

    PYTHONPATH=src python -m repro_torch.launch.profile_gmm

For phi3.5-moe and qwen3-moe: the capacity buffer of one layer at seq
4096 and batch 2 (E groups of batch x capacity rows, random bf16 values
from seed 0), and its four expert products as the train step runs them —
gate/up and down forward, and their dX on the transposed weights — each
timed as K4 (``moe_gmm_cuda``) and as ``torch.bmm`` on the equal-group
layout.  A time is the median over 10 replays of a CUDA graph of 5 calls
(``kernels.timing.time_ms``: no launch overhead).  Prints one line a
product, the card's name and power limit, and the rows as JSON; needs a
CUDA device.  To time another checkout's K4 with this script, run it by
path with that checkout's ``src`` first on ``PYTHONPATH``:

    PYTHONPATH=<other>/src python src/repro_torch/launch/profile_gmm.py

and alternate the two trees in one call (parent, change, change, parent).
``chip_smoke.py`` phase 22 times K4 on this tree alone.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import moe_gmm
from repro_torch.kernels.timing import time_ms
from repro_torch.models import moe

BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
SEQ, BATCH, SEED = 4096, 2, 0
REPS, INNER = 10, 5     # graph replays, calls a graph


def profile(arch: str, gen: torch.Generator):
    cfg = get_config(arch)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    G = BATCH * moe.moe_capacity(cfg, SEQ)
    M = E * G
    dev = torch.device("cuda")
    sizes = torch.full((E,), G, dtype=torch.int32, device=dev)
    for name, K, N, trans in (("gate/up", D, F, False), ("down", F, D, False),
                              ("gate/up dX", F, D, True),
                              ("down dX", D, F, True)):
        x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
        w = (torch.randn((E, N, K) if trans else (E, K, N), generator=gen,
                         device=dev) * K ** -0.5).bfloat16()
        ms = time_ms(lambda: moe_gmm.moe_gmm_cuda(x, sizes, w,
                                                  transpose_w=trans),
                     REPS, INNER)
        xb, wb = x.view(E, G, K), (w.transpose(1, 2) if trans else w)
        bmm_ms = time_ms(lambda: torch.bmm(xb, wb), REPS, INNER)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (M * K + E * K * N + M * N)
        bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        yield dict(arch=cfg.name, product=name, M=M, K=K, N=N, E=E,
                   transposed_w=trans, ms=ms, tflops=flops / ms / 1e9,
                   bound_ms=bound, bmm_ms=bmm_ms,
                   bmm_tflops=flops / bmm_ms / 1e9)
        del x, w, xb, wb
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_gmm needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for arch in ARCHS:
        for r in profile(arch, gen):
            print(f"{r['arch']} {r['product']}: M={r['M']} K={r['K']} "
                  f"N={r['N']} E={r['E']} K4 {r['ms']:.4f} ms "
                  f"({r['tflops']:.1f} TFLOP/s), bound {r['bound_ms']:.4f} "
                  f"ms, bmm {r['bmm_ms']:.4f} ms ({r['bmm_tflops']:.1f} "
                  f"TFLOP/s)", flush=True)
            rows.append(r)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "products": rows}))


if __name__ == "__main__":
    main()
