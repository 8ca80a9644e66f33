"""Chip smoke of the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, and serve full-width
qwen2-1.5b through the paged engine (main path), the fused engine and
the paged engine's speculative path.

    python3 chip_smoke.py

Needs one NVIDIA GPU and nvcc; exits non-zero (printing no result) without
them, and on any mismatch.  Phases, one or more lines each:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the kernels compiled from ``src/repro_torch/kernels/csrc``;
  3. K1 (flash prefill) against its plain version at qwen2 shapes;
  4. K2 (paged decode) against its plain version at qwen2 shapes;
  5. main path: ``smoke_serve`` with the paged engine at full width
     (launch counters reset just before, read just after), then the
     serving bench's shared-prefix burst;
  6. the same workload on the fused engine, and the first admission
     group's prefill and decode logits, kernel path vs plain path;
  7. K3 (paged verify) against its plain version at qwen2 shapes, and
     against K2 at one row;
  8. the speculative path: the paged engine with the n-gram proposer at
     full width (launch counters reset just before, read just after),
     beside the same workload without speculation; greedy identity with
     and without speculation on one admission group in float32 (and the
     agreeing share in bf16); one verify step's logits, kernel path vs
     plain path; a burst through a 2-layer draft model.

The second-to-last lines are the kernel table (JSON) and the
``nvidia-smi`` name/power line; the last line is the result JSON.
Weights are random, from a seed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, flash_attention, ops  # noqa: E402
from repro_torch.kernels import paged_attention, paged_attention_mq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Request, ServeEngine, smoke_serve  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_FLOPS = 989e12         # H100 SXM, dense tensor cores
F32_FLOPS = 67e12           # H100 SXM, outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# kernel path vs plain path, max |diff| / max |logit| over prefill and three
# decode steps at full width: bf16 activations rounded at other points by
# the two attention paths, carried through 28 layers
LOGIT_REL_BOUND = 5e-2

# the serving workload (paged main path and fused): qwen2 shapes
NUM_REQUESTS, MAX_BATCH, PROMPT_LEN, MAX_NEW, PAGE = 16, 8, 64, 32, 16
MAX_SEQ = PROMPT_LEN + MAX_NEW  # the last decode writes at 94
# the speculative path: a verify pass entered one token before the budget
# writes SPEC_K rows past it, 64 + 32 - 1 + 4 = 99 positions (7 pages)
SPEC_K, SPEC_CHUNK, SPEC_MAX_SEQ = 4, 2, 112


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in a
    CUDA graph, so the host's launch overhead is not counted; the graph is
    replayed ``reps`` times between CUDA events, and the median per call is
    returned.  Inputs stay in the 50 MB L2 between calls, as they do when
    the serving loop calls the kernel once per layer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype] * (1 + want.float().abs())
    bad = int((err > tol).sum())
    assert bad == 0, f"{bad} elements beyond tolerance, max err {err.max()}"
    return float(err.max())


# ---------------------------------------------------------------------------
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    log(f"[1 device] {line} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    build.library()
    log(f"[2 build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")


def _k1_case(name, dtype, B, S, T, H, KH, D, window, gen):
    dev = torch.device("cuda")
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True,
                                               window=window)
    want = flash_attention.plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = max_err(got, want, dtype)
    ms = time_ms(lambda: flash_attention.flash_attention_cuda(
        q, k, v, causal=True, window=window))
    plain_ms = time_ms(lambda: flash_attention.plain(
        q, k, v, causal=True, window=window), reps=5, inner=3)
    # the yardstick: one PyTorch call for the same function (never used by
    # the port), in its (B, H, S, D) layout
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qpos, kpos = torch.arange(S, device=dev), torch.arange(T, device=dev)
    live = qpos[:, None] >= kpos[None, :]
    if window:
        live &= qpos[:, None] - kpos[None, :] < window
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=live, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(lib)
    pairs = int(live.sum())
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (2 * B * S * H * D + 2 * B * T * KH * D)
    flops = 4.0 * B * H * D * pairs
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bms, by = bound_ms(nbytes, flops, peak)
    log(f"[3 K1] {name} {str(dtype)[6:]} B={B} S={S} T={T} H={H} KH={KH} "
        f"D={D} window={window}: max_abs_err={err:.3g} (tol "
        f"{TOL[dtype]:g} abs+rel) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} bound_ms={bms:.5f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def phase_k1(gen) -> dict:
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, S, window, B in (("main-path", PROMPT_LEN, 0, MAX_BATCH),
                                   ("S=T=256", 256, 0, 4),
                                   ("ragged", 200, 0, 4),
                                   ("window", 256, 64, 4)):
            r = _k1_case(name, dtype, B, S, S, 12, 2, 128, window, gen)
            if name == "main-path" and dtype == torch.bfloat16:
                main = r
    return main


def _k2_case(name, dtype, B, KH, G, D, page, max_pages, lens, gen, rng):
    dev = torch.device("cuda")
    P = 1 + B * max_pages
    q = torch.randn((B, 1, KH * G, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    lens = np.asarray(lens, np.int32)
    table = np.full((B, max_pages), -1, np.int32)  # -1 past each kv_len
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(lens[b]) // page)):
            table[b, j] = free.pop()
    tt = torch.from_numpy(table).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    got = paged_attention.paged_attention_cuda(q, kp, vp, tt, tl)
    want = paged_attention.plain(q, kp, vp, tt, tl)
    torch.cuda.synchronize()
    err = max_err(got, want, dtype)
    ms = time_ms(lambda: paged_attention.paged_attention_cuda(q, kp, vp, tt, tl))
    plain_ms = time_ms(lambda: paged_attention.plain(q, kp, vp, tt, tl),
                       reps=5, inner=3)
    size = torch.finfo(dtype).bits // 8
    live = int(lens.sum())
    nbytes = (size * (2 * B * KH * G * D + 2 * live * KH * D)
              + 4 * (B * max_pages + B))
    flops = 4.0 * KH * G * D * live
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bms, by = bound_ms(nbytes, flops, peak)
    log(f"[4 K2] {name} {str(dtype)[6:]} B={B} KH={KH} G={G} D={D} "
        f"page={page} max_pages={max_pages} kv_len={lens.tolist()}: "
        f"max_abs_err={err:.3g} (tol {TOL[dtype]:g} abs+rel) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms=null bound_ms={bms:.5f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_k2(gen) -> dict:
    rng = np.random.default_rng(0)
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        # main path: the paged decode batch at its live lengths (prompt 64
        # + up to 31 decoded tokens; max_seq 96 -> 6 table entries per slot)
        r = _k2_case("main-path", dtype, MAX_BATCH, 2, 6, 128, PAGE,
                     MAX_SEQ // PAGE, [65, 70, 80, 95, 96, 64, 81, 90],
                     gen, rng)
        if dtype == torch.bfloat16:
            main = r
        # long cache, ragged lengths with exact page boundaries and a
        # one-token slot; -1 past each length
        _k2_case("long", dtype, 8, 2, 6, 128, PAGE, 64,
                 [1, 16, 17, 512, 1024, 1000, 333, 32], gen, rng)
    return main


# ---------------------------------------------------------------------------
def phase_serve_paged(model, params, cfg) -> dict:
    flash_attention.launches = 0
    paged_attention.launches = 0
    done, stats = smoke_serve(
        model, params, num_requests=NUM_REQUESTS, vocab_size=cfg.vocab_size,
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, prompt_len=PROMPT_LEN,
        max_new_tokens=MAX_NEW, page_size=PAGE, engine="paged")
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
    assert stats["requests"] == NUM_REQUESTS, stats
    assert all(1 <= len(c.tokens) <= MAX_NEW for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    assert launches["flash_attention"] > 0 and launches["paged_attention"] > 0
    assert stats["pages_in_use"] == 0, "pages leaked after the drain"
    log(f"[5 serve paged] requests={stats['requests']} tokens="
        f"{stats['tokens']} wall_s={stats['step_time_s']:.3f} tok_per_s="
        f"{stats['tok_per_s']:.1f} (first run, set-up included) "
        f"prefix_hit_rate={stats['prefix_hit_rate']:.4f} pages_in_use="
        f"{stats['pages_in_use']} launches={launches}")
    _, warm = smoke_serve(
        model, params, num_requests=NUM_REQUESTS, vocab_size=cfg.vocab_size,
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, prompt_len=PROMPT_LEN,
        max_new_tokens=MAX_NEW, page_size=PAGE, engine="paged")
    log(f"[5 serve paged] warm rerun: tokens={warm['tokens']} wall_s="
        f"{warm['step_time_s']:.3f} tok_per_s={warm['tok_per_s']:.1f}")

    # benchmarks/serve_bench.py shared-prefix burst: 32 requests extend one
    # common two-page prompt; 16 slots, max_seq 48
    eng = ServeEngine(model, params, max_batch=16, max_seq=48, eos_id=-1,
                      engine="paged", page_size=PAGE)
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, cfg.vocab_size, 2 * PAGE)
    for i in range(32):
        eng.submit(Request(uid=i, prompt=np.concatenate(
            [prefix, rng.integers(1, cfg.vocab_size, 4)]), max_new_tokens=8))
    burst = eng.run()
    assert len(burst) == 32 and all(len(c.tokens) == 8 for c in burst)
    assert eng.pool.hit_rate == 0.9375, eng.pool.hit_rate
    assert eng.pool.pages_in_use == 0
    log(f"[5 prefix burst] requests=32 prefix_hit_rate={eng.pool.hit_rate} "
        f"({eng.pool.prefix_hits}/{eng.pool.prefix_lookups}) pages_in_use="
        f"{eng.pool.pages_in_use}")
    return launches


def _to_paged(cache, page: int):
    """The engine's paged layout of a dense prefill cache: slot b's
    logical page j at pool page 1 + b * max_pages + j (page 0 null)."""
    k = cache["k"]
    L, B, S, KH, Dh = k.shape
    mp = S // page
    out = {"page_table": (1 + torch.arange(B * mp, dtype=torch.int32,
                                           device=k.device)).view(B, mp),
           "pos": cache["pos"].clone()}
    for name in ("k", "v"):
        pool = torch.zeros((L, KH, 1 + B * mp, page, Dh), dtype=k.dtype,
                           device=k.device)
        pool[:, :, 1:] = cache[name].view(L, B, mp, page, KH, Dh).permute(
            0, 4, 1, 2, 3, 5).reshape(L, KH, B * mp, page, Dh)
        out[name + "_pool"] = pool
    return out


def _logits_run(model, params, tokens, lens, steps):
    """Prefill, then ``steps`` greedy decode steps on a dense and on a
    paged copy of the cache; returns every logits tensor and the fed
    tokens (``steps`` given: feed those instead of sampling)."""
    logits, cache = model.prefill(params, tokens, max_seq=MAX_SEQ, lens=lens)
    paged = _to_paged(cache, PAGE)
    out = [logits]
    fed = []
    nxt = logits.argmax(-1).to(torch.int32)
    for i in range(3):
        tok = (steps[i] if steps else nxt)[:, None]
        fed.append(tok[:, 0])
        ld, cache = model.decode_step(params, cache, tok)
        lp, paged = model.decode_step(params, paged, tok)
        out += [ld, lp]
        nxt = ld.argmax(-1).to(torch.int32)
    return out, fed


def phase_serve_fused(model, params, cfg) -> float:
    _, stats = smoke_serve(
        model, params, num_requests=NUM_REQUESTS, vocab_size=cfg.vocab_size,
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, prompt_len=PROMPT_LEN,
        max_new_tokens=MAX_NEW, engine="fused")
    assert stats["requests"] == NUM_REQUESTS
    log(f"[6 serve fused] requests={stats['requests']} tokens="
        f"{stats['tokens']} wall_s={stats['step_time_s']:.3f} tok_per_s="
        f"{stats['tok_per_s']:.1f}")

    # the first admission group of that run: its prompts and lengths
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, PROMPT_LEN)
               for _ in range(MAX_BATCH)]
    tokens = torch.tensor(np.stack(prompts), dtype=torch.int32, device="cuda")
    lens = torch.full((MAX_BATCH,), PROMPT_LEN, dtype=torch.int32,
                      device="cuda")
    kern, fed = _logits_run(model, params, tokens, lens, None)
    with mock.patch.object(ops, "flash_attention", ref.attention), \
            mock.patch.object(ops, "paged_decode_attention",
                              ref.paged_attention):
        n0 = (flash_attention.launches, paged_attention.launches)
        plain, _ = _logits_run(model, params, tokens, lens, fed)
        assert (flash_attention.launches, paged_attention.launches) == n0
    names = ["prefill"] + [f"decode{i}_{c}" for i in range(3)
                           for c in ("dense", "paged")]
    worst = 0.0
    for name, a, b in zip(names, kern, plain):
        assert a.shape == (MAX_BATCH, cfg.vocab_size)
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        worst = max(worst, rel)
        log(f"[6 logits] {name}: max|kernel-plain|/max|logit| = {rel:.3g}")
    assert worst <= LOGIT_REL_BOUND, (worst, LOGIT_REL_BOUND)
    log(f"[6 logits] worst {worst:.3g} <= bound {LOGIT_REL_BOUND}")
    return worst


# ---------------------------------------------------------------------------
def _k3_case(name, dtype, B, T, KH, G, D, page, max_pages, base_len, gen,
             rng):
    dev = torch.device("cuda")
    P = 1 + B * max_pages
    q = torch.randn((B, T, KH * G, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    base = np.asarray(base_len, np.int32)
    # what each slot's furthest row sees; -1 past it
    seen = np.minimum(base + T - 1, max_pages * page)
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(seen[b]) // page)):
            table[b, j] = free.pop()
    tt = torch.from_numpy(table).to(dev)
    tb = torch.from_numpy(base).to(dev)
    got = paged_attention_mq.paged_attention_mq_cuda(q, kp, vp, tt, tb)
    want = paged_attention_mq.plain(q, kp, vp, tt, tb)
    torch.cuda.synchronize()
    err = max_err(got, want, dtype)
    extra = ""
    if T == 1:  # one row is single-token decode: K2 on the same inputs
        k2 = paged_attention.paged_attention_cuda(q, kp, vp, tt, tb)
        torch.cuda.synchronize()
        extra = f" vs_K2_max_abs_err={max_err(got, k2, dtype):.3g}"
    ms = time_ms(lambda: paged_attention_mq.paged_attention_mq_cuda(
        q, kp, vp, tt, tb))
    plain_ms = time_ms(lambda: paged_attention_mq.plain(q, kp, vp, tt, tb),
                       reps=5, inner=3)
    size = torch.finfo(dtype).bits // 8
    # q and out once, the K and V each row set can see once, the int32
    # table and lengths; FLOPs 4 D per visible (row, key) pair
    nbytes = (size * (2 * B * T * KH * G * D + 2 * int(seen.sum()) * KH * D)
              + 4 * (B * max_pages + B))
    rows_seen = np.minimum(base[:, None] + np.arange(T)[None],
                           max_pages * page)
    flops = 4.0 * D * KH * G * int(rows_seen.sum())
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    bms, by = bound_ms(nbytes, flops, peak)
    log(f"[7 K3] {name} {str(dtype)[6:]} B={B} T={T} KH={KH} G={G} D={D} "
        f"page={page} max_pages={max_pages} base_len={base.tolist()}: "
        f"max_abs_err={err:.3g} (tol {TOL[dtype]:g} abs+rel){extra} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null "
        f"bound_ms={bms:.5f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def phase_k3(gen) -> dict:
    rng = np.random.default_rng(1)
    main = None
    mp = -(-SPEC_MAX_SEQ // PAGE)  # 7 table entries per slot
    lens = [65, 70, 80, 95, 96, 64, 81, 90]
    for dtype in (torch.bfloat16, torch.float32):
        # main path: the verify batch of the speculative run (T = spec_k + 1)
        r = _k3_case("main-path", dtype, MAX_BATCH, SPEC_K + 1, 2, 6, 128,
                     PAGE, mp, lens, gen, rng)
        if dtype == torch.bfloat16:
            main = r
        _k3_case("long", dtype, 8, 5, 2, 6, 128, PAGE, 64,
                 [1, 16, 17, 512, 1020, 1000, 333, 32], gen, rng)
        # rows ending exactly on page edges, and base_len 1
        _k3_case("page-edges", dtype, 8, 5, 2, 6, 128, PAGE, 8,
                 [1, 12, 16, 17, 28, 32, 48, 64], gen, rng)
        # 80 rows per block (glm4-9b's G = 16 at spec_k = 4)
        _k3_case("G=16", dtype, 4, 5, 2, 16, 128, PAGE, 8,
                 [1, 33, 64, 100], gen, rng)
        _k3_case("T=1", dtype, MAX_BATCH, 1, 2, 6, 128, PAGE, mp, lens, gen,
                 rng)
    return main


# ---------------------------------------------------------------------------
def _burst(eng: ServeEngine, vocab: int, n: int = NUM_REQUESTS):
    """The smoke_serve burst (prompts from seed 0), through the engine's
    own calls; returns (completions, wall seconds)."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(n):
        eng.submit(Request(uid=i, prompt=rng.integers(1, vocab, PROMPT_LEN),
                           max_new_tokens=MAX_NEW))
    done = eng.run()
    return done, time.perf_counter() - t0


def _spec_engine(model, params, spec_k, **kw):
    return ServeEngine(model, params, max_batch=MAX_BATCH,
                       max_seq=SPEC_MAX_SEQ, engine="paged", page_size=PAGE,
                       decode_chunk=SPEC_CHUNK, spec_k=spec_k, **kw)


def _group_tokens(model, params, cfg, spec_k):
    """Greedy tokens of one admission group of MAX_BATCH requests."""
    done, _ = _burst(_spec_engine(model, params, spec_k), cfg.vocab_size,
                     MAX_BATCH)
    return {c.uid: c.tokens for c in done}


def _top2_margin(model, params, prompt, prefix) -> float:
    """The target's top-2 logit margin after ``prompt + prefix``, as a
    share of max |logit|."""
    seq = np.concatenate([prompt, np.asarray(prefix, np.int64)])
    tokens = torch.tensor(seq[None], dtype=torch.int32, device="cuda")
    logits, _ = model.prefill(params, tokens)
    top = torch.topk(logits[0].float(), 2).values
    return float((top[0] - top[1]) / logits[0].float().abs().max())


def phase_serve_spec(model, params, cfg) -> int:
    # main path: the paged engine's speculative decode with the n-gram
    # proposer, counters reset just before and read just after
    for mod in (flash_attention, paged_attention, paged_attention_mq):
        mod.launches = 0
    eng = _spec_engine(model, params, SPEC_K)
    done, wall = _burst(eng, cfg.vocab_size)
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in
                (flash_attention, paged_attention, paged_attention_mq)}
    stats = eng.kv_stats()
    toks = sum(len(c.tokens) for c in done)
    assert len(done) == NUM_REQUESTS
    assert all(1 <= len(c.tokens) <= MAX_NEW for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    assert launches["paged_attention_mq"] > 0, launches
    assert stats["pages_in_use"] == 0, "pages leaked after the drain"
    assert stats["spec_tokens"] == toks - NUM_REQUESTS, stats
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0
    log(f"[8 serve spec] paged ngram spec_k={SPEC_K} chunk={SPEC_CHUNK} "
        f"max_seq={SPEC_MAX_SEQ}: requests={len(done)} tokens={toks} "
        f"wall_s={wall:.3f} tok_per_s={toks / wall:.1f} (first run) "
        f"accept_rate={stats['spec_accept_rate']:.4f} tokens_per_round="
        f"{stats['spec_tokens_per_round']:.3f} slot_rounds="
        f"{stats['spec_rounds']} batch_rounds={eng.chunk_steps_total} "
        f"(used {eng.chunk_steps_used}) transfers={eng.d2h_transfers} "
        f"prefills={launches['flash_attention'] // cfg.num_layers} "
        f"pages_in_use={stats['pages_in_use']} launches={launches}")
    # the same workload without speculation, then with it again (warm)
    for spec_k in (0, SPEC_K):
        e = _spec_engine(model, params, spec_k)
        d, w = _burst(e, cfg.vocab_size)
        n = sum(len(c.tokens) for c in d)
        log(f"[8 serve spec] warm spec_k={spec_k}: tokens={n} wall_s={w:.3f} "
            f"tok_per_s={n / w:.1f}" + (
                f" accept_rate={e.kv_stats()['spec_accept_rate']:.4f} "
                f"tokens_per_round={e.kv_stats()['spec_tokens_per_round']:.3f}"
                if spec_k else ""))

    # greedy identity on one admission group: float32 at full width must
    # agree token for token (a divergence is reported, not failed, only at
    # a near-tie of the target); bf16 reports its agreeing share
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.serving_params(model32.init(seed=0))
    base = _group_tokens(model32, params32, cfg32, 0)
    spec = _group_tokens(model32, params32, cfg32, SPEC_K)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, PROMPT_LEN)
               for _ in range(MAX_BATCH)]
    for uid in base:
        a, b = base[uid], spec[uid]
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        margin = _top2_margin(model32, params32, prompts[uid], a[:i])
        log(f"[8 greedy f32] uid={uid} diverges at token {i}: top-2 margin "
            f"{margin:.3g} of max|logit|")
        assert margin < 1e-3, (uid, i, margin)
    same = sum(base[u] == spec[u] for u in base)
    log(f"[8 greedy f32] {same}/{len(base)} requests token-identical with "
        f"and without speculation")
    del model32, params32
    torch.cuda.empty_cache()
    base = _group_tokens(model, params, cfg, 0)
    spec = _group_tokens(model, params, cfg, SPEC_K)
    pairs = [(x, y) for u in base for x, y in zip(base[u], spec[u])]
    agree = sum(x == y for x, y in pairs) / len(pairs)
    log(f"[8 greedy bf16] share of tokens that agree with and without "
        f"speculation: {agree:.4f} ({len(pairs)} positions)")

    # one verify step's logits, kernel path vs plain path, on one cache
    tokens = torch.tensor(np.stack(prompts), dtype=torch.int32, device="cuda")
    logits, cache = model.prefill(params, tokens, max_seq=SPEC_MAX_SEQ)
    paged = _to_paged(cache, PAGE)
    vt = torch.cat([logits.argmax(-1).to(torch.int32)[:, None],
                    tokens[:, :SPEC_K]], dim=1)
    clone = {k: v.clone() for k, v in paged.items()}
    kern, _ = model.verify_step(params, paged, vt)
    n0 = paged_attention_mq.launches
    with mock.patch.object(ops, "paged_decode_attention_mq",
                           ref.paged_attention_mq):
        plain, _ = model.verify_step(params, clone, vt)
    assert paged_attention_mq.launches == n0
    assert kern.shape == (MAX_BATCH, SPEC_K + 1, cfg.vocab_size)
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    rel = float((kern.float() - plain.float()).abs().max()
                / plain.float().abs().max())
    log(f"[8 verify logits] max|kernel-plain|/max|logit| = {rel:.3g} "
        f"(bound {LOGIT_REL_BOUND})")
    assert rel <= LOGIT_REL_BOUND, (rel, LOGIT_REL_BOUND)

    # the draft-model proposer: qwen2-1.5b's own widths cut to 2 layers
    dcfg = dataclasses.replace(cfg, num_layers=2, name=cfg.name + "-draft2")
    draft = build_model(dcfg)
    dparams = draft.init(seed=1)
    e = _spec_engine(model, params, 2, draft=draft, draft_params=dparams)
    d, w = _burst(e, cfg.vocab_size)
    st = e.kv_stats()
    n = sum(len(c.tokens) for c in d)
    assert len(d) == NUM_REQUESTS and st["pages_in_use"] == 0
    assert st["spec_tokens"] == n - NUM_REQUESTS
    log(f"[8 serve draft] 2-layer draft spec_k=2: requests={len(d)} tokens={n} "
        f"wall_s={w:.3f} tok_per_s={n / w:.1f} accept_rate="
        f"{st['spec_accept_rate']:.4f} pages_in_use={st['pages_in_use']}")
    return launches["paged_attention_mq"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = phase_k1(gen)
    k2 = phase_k2(gen)
    k3 = phase_k3(gen)

    cfg = get_config("qwen2-1.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.serving_params(model.init(seed=0))
    torch.cuda.synchronize()
    log(f"[5 model] {cfg.name} full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B params in "
        f"{cfg.dtype}; init {time.perf_counter() - t0:.1f} s")
    launches = phase_serve_paged(model, params, cfg)
    phase_serve_fused(model, params, cfg)
    k3_launches = phase_serve_spec(model, params, cfg)

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:115",
             launches=launches["flash_attention"], **k1),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:230",
             launches=launches["paged_attention"], **k2),
        dict(name="paged_attention_mq", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention_mq.cu",
             replaces="src/repro/kernels/paged_attention.py:170",
             launches=k3_launches, **k3),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
