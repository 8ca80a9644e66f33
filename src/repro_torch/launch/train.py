"""Training entry point of the port.

    # the reduced config on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 200 --batch 8 --seq 128

    # qwen2-1.5b at full width on one H100
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --full --seq 4096 --batch 2 --steps 4 --remat none

    # xlstm-125m at full width on one H100 (mLSTM through K6 and K6-bwd)
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --full --seq 4096 --batch 8 --steps 4 --device cuda

    # hymba-1.5b at full width on one H100 (SSM heads through K5 and
    # K5-bwd, global and sliding-window attention through K1 and K1-bwd)
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --full --seq 4096 --batch 1 --steps 4 --remat none

    # phi3.5-moe at full width, depth cut to 2 of its 32 layers, on one
    # H100 (the expert FFN through K4 and its backward)
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi3.5-moe-42b-a6.6b --full --layers 2 --seq 4096 \
        --batch 2 --steps 4 --remat none

    # whisper-large-v3 (encoder-decoder: 1500 stub frames a sequence)
    # and phi-3-vision (576 stub image embeddings a sequence) on one H100
    # (final checkpoints of 18.4 and 45.9 GB: point --runs-dir at a disk
    # with room; phi-3-vision's loss rises at lr 1e-4 and above in its
    # first steps, so it trains at 1e-5 here)
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper \
        --full --seq 4096 --batch 2 --steps 4 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-vision \
        --full --seq 4096 --batch 1 --steps 4 --remat full --lr 1e-5

    # on the CPU (the plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi35-moe \
        --device cpu --steps 6

    # a failure drill: steps 3 and 7 die, the envelope restores the
    # newest committed checkpoint and replays the stream from there
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 10 --ckpt-every 2 --fail-at 3 7

    # data parallel over 4 processes (NCCL on the cards, gloo on the CPU)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --steps 6

Counterpart of the reference's ``launch/train.py``, with its flags plus
``--device``.  The loop runs through the port's
:class:`~repro_torch.core.envelope.ExecutionEnvelope` into a run record of
a :class:`~repro_torch.core.provenance.ProvenanceStore` under
``--runs-dir`` (metrics, restore/failure/straggler events): restore from
the newest checkpoint in ``<runs-dir>/ckpt`` or initialise from
``--seed``, run the steps on the data stream's batches (the reference's
batches, byte for byte), save every ``--ckpt-every`` steps and once more,
blocking, at the end; ``--fail-at`` injects failures at those steps,
each answered by a restore from the newest committed checkpoint.  Then
it prints the reference's summary line, with the MoE aux loss of the
last step beside the loss and the restarts.  ``--layers`` cuts the
depth of a reduced or a ``--full`` config.

Under ``torchrun`` with a world of more than one process, the flags are
the same: the world is a ``(world, 1)`` ("data", "model") mesh
(:func:`~repro_torch.launch.mesh.mesh_for_placement`, on
``cuda:LOCAL_RANK`` or the CPU), each rank generates its rows of the
global batch (the stream's ``host_id``/``num_hosts``), holds its blocks
of the state and runs the sharded step; rank 0 writes the checkpoints
and prints, the other ranks keep their run records under
``<runs-dir>/rank<r>``.  A world of one runs as before.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.envelope import ExecutionEnvelope
from repro_torch.core.provenance import ProvenanceStore
from repro_torch.data import DataConfig, make_stream
from repro_torch.ft.elastic import reshard_state, state_shardings
from repro_torch.ft.failures import FailureSchedule
from repro_torch.launch.mesh import backend_for, mesh_for_placement
from repro_torch.models import build_model
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               keep_input_state, make_train_step)
from repro_torch.tree import leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model for mid-size runs (e.g. ~100M)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--runs-dir", default="runs")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT drill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-donate", action="store_true",
                    help="leave the caller's train state intact (a copy is "
                         "updated) instead of updating it in place")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a GPU")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.width:
            over.update(d_model=args.width,
                        num_heads=max(4, args.width // 64),
                        num_kv_heads=max(2, args.width // 128), head_dim=64,
                        d_ff=0 if cfg.d_ff == 0 else args.width * 4,
                        vocab_size=8192)
        if args.layers:
            over["num_layers"] = args.layers
        cfg = reduced(cfg, **over)
    elif args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    world, rank = int(os.environ.get("WORLD_SIZE", 1)), 0
    mesh = layouts = None
    device = args.device
    if world > 1:  # under torchrun: one rank a process
        rank = int(os.environ["RANK"])
        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        dist.init_process_group(backend_for(torch.device(device)))
        mesh = mesh_for_placement((world, 1), ("data", "model"), device)
    model = build_model(cfg, device=device)

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    plan = Plan(remat=args.remat, microbatch=args.microbatch)
    stream = make_stream(cfg, shape, DataConfig(
        seed=args.seed, vocab_size=min(4096, cfg.vocab_size)),
        host_id=rank, num_hosts=world)
    step_fn = make_train_step(model, opt, plan, mesh)
    if mesh is not None:
        layouts = state_shardings({}, model, mesh, plan)
    if args.no_donate:
        step_fn = keep_input_state(step_fn)
    ckpt = Checkpointer(os.path.join(args.runs_dir, "ckpt"), keep=2)
    runs_dir = args.runs_dir if rank == 0 else os.path.join(
        args.runs_dir, f"rank{rank}")
    record = ProvenanceStore(runs_dir).create_run(
        template=f"cli-train-{args.arch}", template_version="0",
        config={"arch": args.arch, "cfg": dataclasses.asdict(cfg),
                "steps": args.steps, "batch": args.batch, "seq": args.seq,
                "device": str(model.device)},
        plan={"remat": args.remat, "microbatch": args.microbatch},
    )
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"run: {record.run_id}")
    n_params = 0

    def init_fn():
        nonlocal n_params
        state = init_train_state(model, args.seed, opt, plan)
        n_params = sum(p.numel() for p in leaves(state["params"]))
        return state if mesh is None else reshard_state(state, model, mesh,
                                                        plan)

    def run_step(state, step):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in stream.batch_at(step).items()}
        for k in ("frames", "image_embeds"):  # the reference's bf16 casts
            if k in batch:
                batch[k] = batch[k].to(torch.bfloat16)
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits
        say(f"step {step} loss={metrics['loss']:.4f} "
              f"aux={metrics['aux']:.4g} lr={metrics['lr']:.3g} "
              f"grad_norm={metrics['grad_norm']:.4f}", flush=True)
        return state, metrics

    if ckpt.latest_step() is not None:
        say(f"restored step {ckpt.latest_step()} from {ckpt.dir}")
    env = ExecutionEnvelope(
        record, checkpointer=ckpt, checkpoint_every=args.ckpt_every,
        failures=FailureSchedule(tuple(args.fail_at)) if args.fail_at
        else None)
    t0 = time.time()
    env.run(init_state=init_fn, step_fn=run_step, num_steps=args.steps,
            state_shardings=layouts)
    dt = time.time() - t0
    hist = record.metrics()
    losses = [h["loss"] for h in hist]
    aux = hist[-1]["aux"] if hist else 0.0
    tok_s = args.batch * args.seq * len(losses) / dt
    span = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (aux {aux:.4g}) "
            if losses else "")
    say(f"params={n_params/1e6:.1f}M steps={len(losses)} {span}"
        f"wall={dt:.1f}s ({tok_s:,.0f} tok/s) restarts={env.restarts} "
        f"device={model.device}" + (f" world={world}" if world > 1 else ""))
    if world > 1:
        dist.destroy_process_group()

if __name__ == "__main__":
    main()
