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

``--device cpu`` runs the same on gloo processes at ``reduced()`` width
in float32 (seq 16, a rehearsal of the control flow: its times are the
CPU's, and nothing is profiled).
"""
from __future__ import annotations

import argparse
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
