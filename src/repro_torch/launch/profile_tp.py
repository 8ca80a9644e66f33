"""The sharded train step split over ``model`` on a world of several
cards: the tool that times tensor and context parallelism against data
parallelism on one host.

    PYTHONPATH=src python -m repro_torch.launch.profile_tp \\
        [--arch qwen2-1.5b ...] [--layers L] \\
        [--meshes 4x1 1x4 2x2 1x4:seq] [--steps 4]

Starts one process a card (``torch.multiprocessing``, NCCL through
``tcp://localhost`` at a free port) and, for each architecture of
``--arch`` (qwen2-1.5b by default) and each ``("data", "model")`` mesh
in turn, trains it at full width (seq 4096, global batch 4, remat full,
FSDP on, bf16 compute, random weights from seed 0; full depth, or
``--layers`` layers, the encoder-decoder's encoder cut alike) through
``make_train_artifacts`` on the same batches (with the stream's frames
or image embeddings): ``--steps`` steps, each timed on the host to its
loss read, then one step under ``torch.profiler`` on rank 0.  A mesh
written ``DxM:seq`` runs with ``seq_shard_attn`` (attention split by the
sequence instead of by heads).  Each rank starts from the whole initial
state, keeps a copy of its blocks and frees the rest before the peak is
reset.  Prints one line and one JSON row a mesh (attention's mode:
``heads``, ``seq`` or ``none``, not split): the losses, the median step
after the first and its tokens a second, the peak device memory (the
largest over the ranks), and the profiled step's device time, its NCCL
kernels' and their count; then the card's name and power limit.  The
mesh's losses are the same function's at every shape, each summed in
another order in bf16.

``--serve`` serves instead (``serve/sharded.py``, the dense decoders
split over ``model``): for each architecture, in bf16 and then in
float32, rank 0 first serves it unsplit on its one card (the model's
own ``prefill`` and ``decode_step``), then every mesh serves it split:
``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` random tokens (seed 0)
prefilled into a cache of ``SERVE_CACHE`` positions, then
``SERVE_STEPS`` greedy decode steps, the last under ``torch.profiler``
on rank 0.  Parameters are drawn in the compute dtype from seed 0 (the
same for both runs).  Prints per run the prefill ms and the median
decode step ms (each synchronized, on the host clock, the profiled step
left out), the peak device memory (the largest over the ranks), the
profiled step's device and NCCL ms and its busiest host ops, one
all-reduce's latency over ``model``, and whether the greedy tokens are
the one-card run's (where they are not, where each slot's part and the
margins there); exits non-zero when float32's are not.

``--device cpu`` runs the same on gloo processes at ``reduced()`` width
in float32 (seq 16, a rehearsal of the control flow: its times are the
CPU's, and nothing is profiled; serving: float32 alone, prompts of 64
into a cache of 1024, 4 steps).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import socket
import statistics
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH, SEQ, BATCH = "qwen2-1.5b", 4096, 4
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 4, 4096, 32768, 32


def arch_config(arch: str, layers: int = 0, *, cuda: bool = True):
    """``arch``'s config at full width (its depth cut to ``layers``, the
    encoder's too) on the card; at ``reduced()`` width in float32 off
    it."""
    from repro_torch.configs import get_config, reduced

    cfg = get_config(arch)
    if not cuda:
        return dataclasses.replace(reduced(cfg), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
            layers if cfg.is_encoder_decoder else 0))
    return cfg


def _mesh_shape(text: str):
    """``"DxM"`` or ``"DxM:seq"`` -> ``((D, M), seq_shard_attn)``."""
    shape, _, mode = text.partition(":")
    return tuple(int(x) for x in shape.split("x")), mode == "seq"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl(prof):
    """Device ms of all kernels and of the NCCL kernels, and their count."""
    total = nccl = 0.0
    n = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        total += ms
        if "nccl" in e.name.lower():
            nccl += ms
            n += 1
    return total, nccl, n


def run_mesh(arch, shape, seq_shard, args, device):
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import make_stream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import shard_tree, tensor
    from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                                   make_train_artifacts, shard_batch)
    from repro_torch.tree import tree_map

    cuda = device.type == "cuda"
    cfg = arch_config(arch, args.layers, cuda=cuda)
    seq = SEQ if cuda else 16
    mesh = make_mesh(shape, ("data", "model"), device=device)
    model = build_model(cfg, device=device)
    plan = Plan(remat="full", seq_shard_attn=seq_shard)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    tshape = ShapeConfig("train_4k-cut", seq, BATCH, "train")
    art = make_train_artifacts(model, mesh, plan, opt, tshape)
    stream = make_stream(cfg, tshape)
    batches = [shard_batch({k: torch.from_numpy(v).to(device)
                            for k, v in stream.batch_at(i).items()},
                           mesh, plan) for i in range(args.steps + 1)]
    whole = init_train_state(model, 0, opt, plan)
    state = tree_map(lambda x: x.clone(),
                     shard_tree(whole, art.state_shardings))
    del whole
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    losses, walls = [], []
    for i in range(args.steps):
        dist.barrier()
        t0 = time.perf_counter()
        state, metrics = art.step_fn(state, batches[i])
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.zeros((), device=device)
    total = nccl = 0.0
    n_nccl = 0
    if cuda:
        peak.fill_(torch.cuda.max_memory_allocated(device) / 1e9)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        dist.barrier()
        with torch.profiler.profile(activities=acts) as prof:
            state, metrics = art.step_fn(state, batches[args.steps])
            float(metrics["loss"])
        total, nccl, n_nccl = _nccl(prof)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    steady = statistics.median(walls[1:])
    row = dict(arch=arch, layers=cfg.num_layers, mesh=list(shape),
               seq_shard_attn=seq_shard,
               attn=tensor.attn_mode(cfg, plan, shape[1], seq) or "none",
               losses=losses,
               step_wall_s=walls, median_step_s=steady,
               tok_per_s=BATCH * seq / steady, peak_gb=float(peak),
               device_ms=total, nccl_ms=nccl, nccl_kernels=n_nccl,
               device=(torch.cuda.get_device_name(device) if cuda
                       else "cpu"))
    del state, art, batches
    if cuda:
        torch.cuda.empty_cache()
    return row


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(prefill, decode, tokens, steps, device, profile=False):
    """Prefill ``tokens``, then ``steps`` greedy decode steps: ``(tokens
    chosen (B, steps), each choice's margin (B, steps): its top two
    logits apart over the row's max |logit|, prefill ms, decode step ms
    each, the profile of the last step or None)``, after one untimed
    prefill and decode step (the first calls' set-up).  ``profile``: the
    last step runs under ``torch.profiler`` (its wall then counts the
    profiler too)."""
    logits, cache = prefill(tokens)
    decode(cache, logits.argmax(-1).to(torch.int32)[:, None])
    del logits, cache
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(tokens)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    chosen, margins, walls, prof = [], [], [], None
    for i in range(steps):
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        chosen.append(nxt)
        top = logits.float().topk(2, -1).values
        margins.append((top[:, 0] - top[:, 1])
                       / logits.float().abs().amax(-1))
        t0 = time.perf_counter()
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
              if profile and i == steps - 1 else
              contextlib.nullcontext()) as prof_:
            logits, cache = decode(cache, nxt)
            _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        prof = prof_ or prof
    del cache
    return (torch.cat(chosen, 1).cpu(), torch.stack(margins, 1).cpu(),
            prefill_ms, walls, prof)


def _collective_us(mesh, x, reps: int = 50) -> float:
    """Microseconds of one all-reduce of ``x`` over ``model``: ``reps``
    back to back after a barrier, synchronized at the end."""
    from repro_torch.parallel import collectives

    collectives.all_reduce(x, mesh, "model")
    dist.barrier()
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        collectives.all_reduce(x, mesh, "model")
    _sync(x.device)
    return (time.perf_counter() - t0) / reps * 1e6


def serve_arch(rank, arch, args, device) -> None:
    """:func:`_serve` unsplit on rank 0's card, then split on every mesh
    of ``args.meshes``, in bf16 and then float32 on the card (float32
    off it); the last step profiled on rank 0's card; rank 0 prints
    a line and a JSON row a run."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import shard_tree, tensor
    from repro_torch.parallel.sharding import Sharding
    from repro_torch.serve.sharded import make_serve_artifacts
    from repro_torch.train import Plan
    from repro_torch.tree import tree_map

    cuda = device.type == "cuda"
    prompt, cache_len, steps = (SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS) \
        if cuda else (64, 1024, 4)
    for dt in ("bfloat16", "float32") if cuda else ("float32",):
        cfg = get_config(arch) if cuda else reduced(get_config(arch))
        cfg = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        if args.layers:
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        model = build_model(cfg, device=device)
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt),
                               generator=gen, dtype=torch.int32).to(device)
        base = None
        if rank == 0:
            params = model.init(seed=0)
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            with torch.no_grad():
                base, base_margin, pf, walls, prof = _serve(
                    lambda t: model.prefill(params, t, max_seq=cache_len),
                    lambda c, t: model.decode_step(params, c, t), tokens,
                    steps, device, cuda)
            del params
            _report_serve(arch, dt, "1 card, unsplit", "none", pf, walls,
                          _peak(device), None, device, prof)
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
        for text in args.meshes:
            shape, seq_shard = _mesh_shape(text)
            mesh = make_mesh(shape, ("data", "model"), device=device)
            plan = Plan(seq_shard_attn=seq_shard)
            art = make_serve_artifacts(model, mesh, plan, SERVE_BATCH,
                                       cache_len)
            whole = model.init(seed=0)
            params = tree_map(lambda x: x.clone(),
                              shard_tree(whole, art.param_shardings))
            del whole
            rows = Sharding(mesh, (("data",), ()), tuple(tokens.shape))
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            dist.barrier()
            got, margin, pf, walls, prof = _serve(
                lambda t: art.prefill_fn(params, t),
                lambda c, t: art.decode_fn(params, c, t),
                rows.local(tokens), steps, device, cuda and rank == 0)
            peak = torch.full((), _peak(device), device=device)
            dist.all_reduce(peak, op=dist.ReduceOp.MAX)
            lat = _collective_us(mesh, torch.zeros(
                (SERVE_BATCH // shape[0], 1, cfg.d_model),
                dtype=getattr(torch, dt), device=device))
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, (mesh.coord("data"),
                                           mesh.coord("model"), got,
                                           margin))
            if rank == 0:
                mine = [p for p in sorted(parts, key=lambda x: x[:2])
                        if p[1] == 0]
                split = torch.cat([p[2] for p in mine])
                same = bool(torch.equal(split, base))
                if not same:
                    _report_parting(base, split, base_margin,
                                    torch.cat([p[3] for p in mine]))
                attn = tensor.attn_mode(cfg, plan, shape[1], prompt) \
                    if shape[1] > 1 else None
                _report_serve(arch, dt, text, attn or "none", pf, walls,
                              float(peak), same, device, prof, lat)
                if dt == "float32" and not same:
                    raise SystemExit(f"{arch} {text} float32: greedy tokens "
                                     f"differ from the one-card run's")
            del params, art
            if cuda:
                torch.cuda.empty_cache()


def _report_parting(base, split, base_margin, split_margin) -> None:
    """Where each slot's split tokens first part from the one-card
    run's, with both runs' margins at that choice."""
    for b in range(base.shape[0]):
        diff = (base[b] != split[b]).nonzero()
        if len(diff):
            i = int(diff[0])
            print(f"[profile_tp serve]   slot {b} parts at step {i} of "
                  f"{base.shape[1]}: margin there one card "
                  f"{float(base_margin[b, i]):.2e}, split "
                  f"{float(split_margin[b, i]):.2e} of max |logit|; "
                  f"smallest one-card margin before it "
                  f"{float(base_margin[b, :i + 1].min()):.2e}", flush=True)


def _peak(device) -> float:
    return (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else 0.0)


def _report_serve(arch, dt, text, attn, prefill_ms, walls, peak, same,
                  device, prof=None, allreduce_us=None) -> None:
    timed = walls[:-1] if prof is not None else walls  # the profiled one
    row = dict(arch=arch, dtype=dt, mesh=text, attn=attn,
               prompts=SERVE_BATCH, prefill_ms=prefill_ms,
               decode_step_ms=statistics.median(timed[1:] or timed),
               decode_walls_ms=walls, peak_gb=peak,
               tokens_match_one_card=same, allreduce_us=allreduce_us,
               device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"))
    if prof is not None:
        total, nccl, n = _nccl(prof)
        row.update(profiled_step_device_ms=total, profiled_step_nccl_ms=nccl,
                   profiled_step_nccl_kernels=n)
    print(f"[profile_tp serve] {arch} {dt} {text} attention by {attn}: "
          f"prefill {prefill_ms:.1f} ms, decode step "
          f"{row['decode_step_ms']:.2f} ms (median after the first), peak "
          f"{peak:.3f} GB a rank, greedy tokens the one-card run's: {same}"
          + ("" if allreduce_us is None else
             f"; one all-reduce of B·D over model {allreduce_us:.1f} us")
          + ("" if prof is None else
             f"; profiled step {walls[-1]:.1f} ms: device "
             f"{row['profiled_step_device_ms']:.2f} ms, NCCL "
             f"{row['profiled_step_nccl_ms']:.2f} ms in "
             f"{row['profiled_step_nccl_kernels']} kernels"), flush=True)
    if prof is not None:
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=12), flush=True)
    print(json.dumps(row), flush=True)


def _rank(rank, world, port, args):
    cuda = args.device == "cuda"
    device = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        for arch in args.arch:
            if args.serve:
                serve_arch(rank, arch, args, device)
                continue
            for text in args.meshes:
                _report(rank, arch, text, run_mesh(
                    arch, *_mesh_shape(text), args, device))
    finally:
        dist.destroy_process_group()


def _report(rank: int, arch: str, text: str, row: dict) -> None:
    if rank == 0:
        print(f"[profile_tp] {arch} mesh {text} attention by {row['attn']}: "
              f"median step {row['median_step_s']:.4f} s "
              f"({row['tok_per_s']:.0f} tok/s), peak "
              f"{row['peak_gb']:.3f} GB, profiled step "
              f"{row['device_ms']:.1f} device ms, NCCL "
              f"{row['nccl_ms']:.3f} ms in {row['nccl_kernels']} "
              f"kernels; losses {row['losses']}", flush=True)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=[ARCH])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--meshes", nargs="+",
                    default=["4x1", "1x4", "2x2", "1x4:seq"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--serve", action="store_true",
                    help="serve split over model instead of training")
    args = ap.parse_args()
    worlds = {a * b for (a, b), _ in map(_mesh_shape, args.meshes)}
    if len(worlds) != 1:
        raise SystemExit(f"meshes of different sizes: {args.meshes}")
    (world,) = worlds
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} cards needed, "
                         f"{torch.cuda.device_count()} present")
    mp.start_processes(_rank, args=(world, _free_port(), args),
                       nprocs=world, start_method="spawn")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
