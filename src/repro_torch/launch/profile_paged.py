"""K2 (paged decode) and K3 (paged verify) on the card: the time of each at
three shapes, the merge kernel's share, the path each launch took, and
the wrapper's host time per call, beside the card's name and power limit:
the tool that times two trees' paged kernels in one chip call.

    PYTHONPATH=src python -m repro_torch.launch.profile_paged

Shapes (qwen2-1.5b's KV heads 2, query heads 12, head dim 128, pages of
16, bf16; random values and a random page table from seed 0, each slot's
pages distinct; K3 at T = 5, spec_k 4):
  * main-path: the serving smoke's decode batch, B 8 at kv_len 64-96
    (6 table entries; K3 7 entries at base_len 64-96);
  * decode_32k: one layer of the ``serve-qwen2-1.5b`` template's
    decode_32k shape, B 128 at kv_len 32768 (K3 base_len 32764);
  * batch8-32k: B 8 at kv_len 32768 (K3 base_len 32764), where a split
    over the sequence has to fill the card.
A time is the median over 15 replays of a CUDA graph of 20 calls
(``kernels.timing.time_ms``: no launch overhead), with the pools hot in
the L2 and, at the main path, also cold (a rotation through copies of the
pools that together hold twice the L2); beside it an empty kernel's time
in the same kind of graph (the launch floor) and the bound (each live
K/V byte, q and the output once, over 3.35 TB/s).  The split is the
device time of each kernel by name, summed over 5 calls under
``torch.profiler`` and divided by 5.  Host time is the wall time of 200
calls without a synchronise, over 200 (the median and the least of 21
rounds).  Prints one line a kernel and shape, the card's name and power
limit, and the rows as JSON; needs a CUDA device.  To time another checkout's kernels with
this script, run it by path with that checkout's ``src`` first on
``PYTHONPATH`` (that checkout needs this tree's ``kernels/timing.py``):

    PYTHONPATH=<other>/src python src/repro_torch/launch/profile_paged.py

and alternate the two trees in one call (parent, change, change,
parent).
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import build, paged_attention, paged_attention_mq
from repro_torch.kernels.timing import cold_copies, time_ms

KH, G, D, PAGE, T = 2, 6, 128, 16, 5
MAIN_LENS = [65, 70, 80, 95, 96, 64, 81, 90]
# (name, B, kv_len or lengths, table entries a slot)
SHAPES = (("main-path", 8, MAIN_LENS, 6),
          ("decode_32k", 128, 32768, 2048),
          ("batch8-32k", 8, 32768, 2048))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SEED = 0
SPLIT_CALLS = 5
HOST_CALLS, HOST_ROUNDS = 200, 21


def _inputs(B, T_, lens, max_pages, gen, rng):
    """q (B, T_, H, D), pools with 1 + B * max_pages pages, a table of
    distinct random pages for the positions the furthest row sees, -1
    past them, and the lengths (kv_len for T_ = 1, else base_len)."""
    dev = torch.device("cuda")
    P = 1 + B * max_pages
    q = torch.randn((B, T_, KH * G, D), generator=gen, device=dev).bfloat16()
    kp = torch.randn((KH, P, PAGE, D), generator=gen, device=dev).bfloat16()
    vp = torch.randn((KH, P, PAGE, D), generator=gen, device=dev).bfloat16()
    base = np.asarray(lens, np.int32)
    seen = np.minimum(base + T_ - 1, max_pages * PAGE)
    table = np.full((B, max_pages), -1, np.int32)
    free = rng.permutation(np.arange(1, P)).astype(np.int32)
    at = 0
    for b in range(B):
        n = -(-int(seen[b]) // PAGE)
        table[b, :n] = free[at:at + n]
        at += n
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(base).to(dev)), seen


def _split(fn):
    """Device ms a call of ``fn`` by kernel name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(SPLIT_CALLS):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name().replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name.replace("void ", ""))[0]
        name = name.rsplit("::", 1)[-1]
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e6
    return {k: v / SPLIT_CALLS for k, v in by_name.items()}


def host_us(fn) -> tuple:
    """Host microseconds a call of ``fn`` (no synchronise between calls):
    the median and the least of the rounds."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(HOST_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        rounds.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds), min(rounds)


def launch_floor_ms():
    """An empty kernel's time in a graph, where the library has one."""
    lib = build.library()
    if not hasattr(lib, "repro_launch_floor"):
        return None
    from repro_torch.kernels.timing import launch_floor_ms as floor
    return floor()


def _counts(mod):
    return {k: getattr(mod, k, None) for k in
            ("launches", "tc_launches", "fma_launches", "merge_launches")}


def profile(kernel: str, name: str, B: int, lens, max_pages: int, gen, rng):
    mod, fn, T_ = ((paged_attention, paged_attention.paged_attention_cuda, 1)
                   if kernel == "K2" else
                   (paged_attention_mq,
                    paged_attention_mq.paged_attention_mq_cuda, T))
    if kernel == "K3":
        max_pages += name == "main-path"  # the spec engine's 7 entries
        lens = (lens if isinstance(lens, list) else lens - (T - 1))
    lens = lens if isinstance(lens, list) else [lens] * B
    xs, seen = _inputs(B, T_, lens, max_pages, gen, rng)
    q, kp, vp, tt, tl = xs
    before = _counts(mod)
    fn(*xs)
    torch.cuda.synchronize()
    after = _counts(mod)
    paths = {k: (after[k] - before[k] if after[k] is not None else None)
             for k in after}
    ms = time_ms(lambda: fn(*xs))
    row = dict(kernel=kernel, shape=name, B=B, T=T_, max_pages=max_pages,
               ms=ms, paths=paths)
    if name == "main-path":
        n = cold_copies(2 * kp.numel() * kp.element_size())
        pools = [(kp.clone(), vp.clone()) for _ in range(n)]
        row["ms_cold"] = time_ms(lambda i: fn(q, *pools[i], tt, tl), cold=n)
        row["cold_copies"] = n
        row["host_us"], row["host_us_min"] = host_us(lambda: fn(*xs))
        del pools
    nbytes = (2 * (2 * q.numel()) + 2 * 2 * int(seen.sum()) * KH * D
              + 4 * (tt.numel() + tl.numel()))
    row["bytes"] = nbytes
    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    row["split"] = _split(lambda: fn(*xs))
    print(f"{kernel} {name} B={B} T={T_} max_pages={max_pages}: ms={ms:.5f}"
          + (f" ms_cold={row['ms_cold']:.5f} ({row['cold_copies']} pool "
             f"copies) host_us={row['host_us']:.2f} (least "
             f"{row['host_us_min']:.2f})" if "host_us" in row
             else "")
          + f" bound_ms={row['bound_ms']:.5f} paths={paths} by kernel "
          "(profiler, ms a call): " + ", ".join(
              f"{k} {v:.5f}" for k, v in sorted(row["split"].items(),
                                                 key=lambda kv: -kv[1])),
          flush=True)
    del xs, q, kp, vp
    torch.cuda.empty_cache()
    return row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_paged needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = [profile(kernel, *shape, gen, rng) for shape in SHAPES
            for kernel in ("K2", "K3")]
    floor = launch_floor_ms()
    print(f"launch floor (empty kernel in a graph): "
          f"{'not available' if floor is None else f'{floor:.5f} ms'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"rows": rows, "launch_floor_ms": floor}))


if __name__ == "__main__":
    main()
