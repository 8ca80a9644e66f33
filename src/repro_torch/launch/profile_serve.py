"""Where a serving decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch qwen2-1.5b --engine paged --steps 8

Builds the model at full width (random weights from ``--seed``), fills
every slot of the engine with a request, decodes a few warm-up steps,
times ``--steps`` decode steps, traces as many again with
``torch.profiler``, and prints: the host wall time per step (untraced,
and traced), the device's busy time per step (the sum of the kernels'
device times — one stream, so they do not overlap), the device's idle
share of the untraced step, and the kernels that take the most device
time.
``--spec-k K`` profiles speculative rounds (n-gram proposer, one verify
pass of ``K + 1`` rows each) in place of decode steps, and also prints
the tokens each round committed.  ``--trace`` also writes the Chrome
trace.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _is_kernel(evt) -> bool:
    """A device-side event (a kernel or a copy), not the host op that
    launched it, so no time is counted twice."""
    return str(evt.device_type).endswith("CUDA") and _device_us(evt) > 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--engine", default="paged", choices=["fused", "paged"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="profile speculative rounds with this many drafts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    model = build_model(cfg, device=args.device)
    if model.device.type != "cuda":
        raise SystemExit("profiling needs the card: --device cuda")
    params = model.serving_params(model.init(args.seed))
    # every slot stays live through the measured steps (no EOS, a budget
    # of one full round per step)
    max_new = (args.warmup + 2 * args.steps + 2) * (args.spec_k + 1)
    eng = ServeEngine(model, params, max_batch=args.max_batch,
                      max_seq=args.prompt_len + max_new + args.spec_k,
                      eos_id=-1, engine=args.engine, seed=args.seed,
                      spec_k=args.spec_k)
    step = eng.step_spec if args.spec_k else eng.step
    rng = np.random.default_rng(args.seed)
    for i in range(args.max_batch):
        eng.submit(Request(uid=i, prompt=rng.integers(
            1, cfg.vocab_size, args.prompt_len), max_new_tokens=max_new))
    for _ in range(args.warmup):  # admission + warm decode steps
        step()
    torch.cuda.synchronize()

    def timed_steps() -> float:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()  # ends with the token transfer: synchronised
        return (time.perf_counter() - t0) / args.steps

    plain_wall = timed_steps()  # without the profiler's own overhead
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_steps()
    events = [e for e in prof.key_averages() if _is_kernel(e)]
    busy = sum(_device_us(e) for e in events) / 1e3 / args.steps  # ms/step
    print(f"device={torch.cuda.get_device_name(0)} arch={cfg.name} "
          f"engine={args.engine} batch={args.max_batch} "
          f"kv_len~{args.prompt_len + args.warmup} spec_k={args.spec_k}")
    if args.spec_k:
        stats = eng.kv_stats()
        print(f"spec_tokens_per_round={stats['spec_tokens_per_round']:.3f} "
              f"spec_accept_rate={stats['spec_accept_rate']:.4f}")
    print(f"host_ms_per_step={plain_wall * 1e3:.3f} (traced: "
          f"{wall * 1e3:.3f}) device_busy_ms_per_step={busy:.3f} "
          f"device_idle_share={max(0.0, 1 - busy / (plain_wall * 1e3)):.3f}")
    kernels = sum(e.count for e in events) / args.steps
    print(f"device_ops_per_step={kernels:.0f}")
    for e in sorted(events, key=_device_us, reverse=True)[:12]:
        share = _device_us(e) / 1e3 / args.steps / max(busy, 1e-9)
        print(f"  {_device_us(e) / args.steps:9.1f} us/step  "
              f"{share:6.1%}  x{e.count // args.steps:<4d} {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
