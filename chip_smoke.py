"""Chip smoke of the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version on the card, serve full-width
qwen2-1.5b through the paged engine (main path), the fused engine, the
legacy engine and the paged engine's speculative path, train it at full
width through the train step (K1 forward, K1-bwd backward; remat none
and dots), train xlstm-125m at full
width (K6 forward, K6-bwd backward, the sLSTM loop), train hymba-1.5b
at full width (K1 and K1-bwd, global and sliding-window, and K5
forward, K5-bwd backward for its SSM heads), and train phi3.5-moe at
full width, depth cut to 2 layers (K4 for the expert FFN forward and
its dX, K1 and K1-bwd); then run the canonical serve and train workflows
through the control plane (``repro_torch.core.run_workflow``); then the
encoder-decoder (whisper-large-v3) and the VLM
(phi-3-vision-4.2b): K1 and K1-bwd at their shapes, each served and
trained at full width, and their templates at full width planned for
the card; last, the parallel layer on an NCCL world of one (the sharded
step, gradient compression, expert parallelism, elastic restore, the
split over ``model``) and K1 and K1-bwd at the split's per-rank shapes.

    python3 chip_smoke.py

Needs one NVIDIA GPU and nvcc; exits non-zero (printing no result) without
them, and on any mismatch.  Phases, one or more lines each, in this
order but for phases 29-31 (the train workflow at full width planned for
the card, whose runs then calibrate the cost model and feed an
exploration of the card's slices), which run right after the build:
phase 31 fits host-clock step times, and a full run's earlier phases
left its global batch 2 slower (ROADMAP §3):

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the kernels compiled from ``src/repro_torch/kernels/csrc``;
  3. K1 (flash prefill) against its plain version at qwen2 shapes, with
     the path each case took (bf16 on the tensor cores, float32 on FMAs)
     and its time over SDPA's;
  4. K2 (paged decode) against its plain version at qwen2 shapes, with
     the path each case took (bf16 on the tensor cores, float32 on FMAs,
     "+merge" where the walk was split over the sequence), the main path
     timed with the pools hot and cold (a rotation through copies that
     together hold twice the L2) beside an empty kernel (the launch
     floor), and the shapes where bytes decide: one layer of decode_32k
     (B 128 at 32768 positions) and B 8 at 32768 (bf16; float32 at B 8);
  5. main path: ``smoke_serve`` with the paged engine at full width
     (launch counters reset just before, read just after: every K2
     launch on the tensor cores), then the serving bench's shared-prefix
     burst;
  6. the same workload on the fused engine, and the first admission
     group's prefill and decode logits, kernel path vs plain path; then
     the legacy engine on the same workload (counters reset just before,
     read just after: K1 once a request a layer), its host transfers
     (B x V logits a decode step) and tok/s beside the fused
     engine's, greedy identity with the fused engine on one admission
     group in float32 (and the agreeing share in bf16);
  7. K3 (paged verify) against its plain version at qwen2 shapes (the
     main path hot and cold, and the decode_32k and B 8 long shapes, as
     phase 4), and against K2 at one row, bit for bit; past 64 rows
     (glm4-9b's G = 16 at spec_k 7, 8 and 16: 128, 144 and 272 rows,
     qwen2's G = 6 at spec_k 24: 150 rows, in row tiles);
  8. the speculative path: the paged engine with the n-gram proposer at
     full width (launch counters reset just before, read just after:
     every K3 and K2 launch on the tensor cores),
     beside the same workload without speculation; greedy identity with
     and without speculation on one admission group in float32 (and the
     agreeing share in bf16); one verify step's logits, kernel path vs
     plain path; a burst through a 2-layer draft model;
  9. K1's forward with its LSE and K1-bwd (the attention backward)
     against their plain versions at the training shape and three more
     cases, with a check that K1-bwd is deterministic bit for bit, the
     path each took and its time over SDPA's;
 10. training main path: qwen2-1.5b at full width and full depth, seq
     4096, through ``make_train_step`` (launch counters reset just before
     four steps, read just after: every bf16 K1 and K1-bwd launch on the
     tensor cores), then one profiled step's device-time split; then the
     same four steps at remat ``dots`` from the same state (K1 twice a
     layer a step, K1-bwd once, all on the tensor cores), the step wall
     and the peak beside remat none's, the first step's loss within 1e-6
     of none's;
 11. one step's loss and gradient norm at full width, kernel path vs
     plain path;
 12. resume is exact: 4 steps unbroken against 2 steps, a save and
     restore through the port's Checkpointer, and 2 more (deterministic
     algorithms on), bit for bit;
 13. K6 (the chunkwise mLSTM, with its stats) and K6-bwd against their
     plain versions at xlstm-125m's training shape, at S = 1000 and at
     D = 64, with the path each took (bf16 on the tensor cores, in
     chunks of 64 rows, held against the plain versions at that chunk;
     float32 on FMAs) and a check that both are deterministic bit for
     bit; in float32 against the plain version run in float64, within 4
     times the float32 plain version's own error (at least the float32
     TOL and MLSTM_GRAD_TOL);
 14. xLSTM training main path: xlstm-125m at full width and full depth,
     seq 4096, batch 8, through ``make_train_step`` (launch counters
     reset just before four steps, read just after: every K6 and K6-bwd
     launch on the tensor cores), then one profiled step's device-time
     split (K6, K6-bwd, the sLSTM loop, GEMMs, rest);
 15. one xLSTM step's loss and gradient norm at full width, kernel path
     vs plain path (``mlstm_scan_chunked`` under autograd), bounded in
     float32 compute; in bf16 logged beside the plain path with h moved
     by one ulp (bf16 rounding alone moves the gradient norm by tens of
     percent there);
 16. xLSTM resume is exact at full width (depth cut to one group of 3
     mLSTM + 1 sLSTM blocks), seq 1024, batch 2;
 17. K5 (the selective scan, with its checkpoints) and K5-bwd against
     their plain versions at hymba-1.5b's training shape and at a ragged
     S and Din, in both dtypes (the float32 states, and float32 y,
     against the plain version run in float64, within 4x the float32
     plain version's own error there, as phase 13 holds K6), with a
     check that both are deterministic bit for bit;
 18. K1's forward with its LSE and K1-bwd at hymba-1.5b's attention
     shapes (25 query heads, 5 KV heads of 64), global and with a 2048
     window, in both dtypes, with the path each took and its time over
     SDPA's;
 19. hybrid training main path: hymba-1.5b at full width and full depth,
     seq 4096, through ``make_train_step`` (launch counters reset just
     before four steps, read just after: K1 and K1-bwd all on the tensor
     cores), then one profiled step's
     device-time split (K5, K5-bwd, K1, K1-bwd, GEMMs, rest);
 20. one hymba step's loss, gradient norm and every gradient leaf at
     full width (depth cut to 2 layers: 0 global, 1 a 2048 window, the
     SSM parameters moved off their init), seq 4096, kernel path vs plain
     path (autodiff through the sequential scan and the plain
     attention), in float32 compute;
 21. hymba resume is exact at full width, the same 2-layer cut, seq 4096;
 22. K4 (the grouped expert matmul) against its plain version, with the
     path each case took (bf16 on the tensor cores: wgmma fed by TMA, a
     persistent walk of 128 x 256 tiles; float32 and unaligned widths on
     FMAs): ragged and empty groups, rows past sum(sizes) (zero in K4),
     the transposed-W read, K and N off the tile edges, bf16 and float32,
     phi3.5-moe's layer shapes at batch 2 (M = 20480, D = 4096, F = 6400,
     E = 16: the forward products and the dX products) and qwen3-moe's
     (E = 128, groups of 640 rows, F = 1536), with reruns bit for bit,
     beside ``torch.bmm`` on the equal-group layout (the library
     yardstick);
 23. ``MoeGmm`` (K4, K4 on the transposed weights for dX, dW by bmm)
     against autograd of the plain version at phi3.5-moe's shapes;
 24. MoE training main path: phi3.5-moe at full width, depth cut to 2 of
     its 32 layers, seq 4096, batch 2, through ``make_train_step`` (launch
     counters reset just before four steps, read just after: K4 12 a
     step, all on the tensor cores, and K1 and K1-bwd all on the tensor
     cores), then one profiled step's device-time split (K4, K4's dX,
     the dW GEMMs, K1, K1-bwd, GEMMs, rest);
 25. one MoE step's loss, aux loss and every gradient leaf at the same
     2-layer cut, batch 1, kernel path vs plain path, in float32 compute
     (a bf16 rounding upstream can flip a routing choice);
 26. MoE resume is exact at full d_model and heads, 16 experts top-2,
     depth cut to 2 layers and d_ff to 256 (a 5.4 GB checkpoint), seq
     1024, batch 2;
 27. the serve workflow: ``serve-qwen2-1.5b`` at full width (28 layers,
     d_model 1536, bf16 serving parameters) through the control plane's
     ``run_workflow`` on the card, 8 requests, the paged engine with
     spec_k 4 and then 0 (counters reset just before each run and read
     just after: K1 and K3, then K1 and K2, all on the tensor cores), the
     completions token-identical to ``smoke_serve`` called directly on
     the same weights, the checks passing, and the run record's
     environment event naming the card;
 28. the train workflow: ``train-qwen2-1.5b`` at the template's own
     (reduced) scale through ``run_workflow`` on the card, uninterrupted
     (K1's and K1-bwd's launches), with a failure at step 3, cut at step
     3 then resumed, and with ``executor="processes"`` and the eval stage:
     each final state bit-identical to the uninterrupted run's, the
     checks passing;
 29. the card in the catalog: the default catalog holds no H100 slice;
     ``register_card`` adds ``h100-1`` and ``h100-8`` (two generation
     bumps), and the planner gives ``train_4k`` at global batch 2 and 4 a
     plan on the one-card slice;
 30. the train workflow at full width planned for the card:
     ``train-qwen2-1.5b`` with ``scale="full"`` (28 layers, d_model 1536,
     seq 4096) at global batch 2 and 4, 9 steps each, through
     ``run_workflow`` with an intent naming the card (the plan's own remat
     and microbatch; counters reset just before each run, read just
     after: K1 and K1-bwd all on the tensor cores), the checks passing,
     the plan doc naming the card's one-card slice, the peak memory
     beside the plan's ``bytes_per_device``, the host's load average at
     each run's start and end; each run's final checkpoint (18.5 GB) is
     removed after its run;
 31. harvest, calibrate and explore: each run harvests one sample under
     (h100, train); a workflow of the calibrate stage (activating the
     fit: the scale fallback at two samples) and the explore stage over
     the card's slices at the same arch and shapes; the fit's residual,
     the measured median steps beside the uncalibrated and calibrated
     estimates, and the explore report's frontier under the calibration;
 32. K1's forward with its LSE and K1-bwd at this slice's shapes, in both
     dtypes, against their plain versions, with the path each took (every
     bf16 case on the tensor cores) and its time over SDPA's: whisper's
     encoder self-attention (B 2, S = T = 1500, 20 heads of 64,
     non-causal), its decoder's causal self-attention (S 4096) and its
     cross attention (S 4096 against T 1500, non-causal), and
     phi-3-vision's causal attention at head dim 96 (B 1, S 4096, 32
     heads); and K2 at phi-3-vision's serving shape (4 slots, 32 heads
     of 96, pages of 16, the first decode step's lengths) and K3 at its
     verify shape (T = SPEC_K + 1) hot and cold, in both dtypes (D 96
     takes the FMA walk);
 33. whisper-large-v3 at full width (32 encoder and 32 decoder layers,
     d_model 1280): 8 requests of 1500 frames on the fused engine, two
     prompt lengths admitted in exact-length groups (K1 counted by path),
     each group's greedy tokens identical to the same group prefilled and
     decoded directly; then training at seq 4096, batch 2, remat full
     (the decoder blocks) through ``make_train_step`` (counters reset
     just before four steps, read just after: K1 160 and K1-bwd 96 a
     step, all on the tensor cores), the peak memory and one profiled
     step's split and idle share;
 34. phi-3-vision-4.2b at full width (32 layers, d_model 3072, 32 heads
     of 96): 8 image requests (576 image positions and a text prompt) on
     the fused and the paged engine (counters reset just before, read
     just after: K2 at D 96 on its FMA walk), the agreeing share of
     their bf16 tokens, and in float32 compute identical tokens from both
     and a shared prompt's pages reused; the paged engine with spec_k
     SPEC_K (n-gram) on the same requests (K3 at D 96 on its FMA walk):
     acceptance and tokens per round, the agreeing share with the paged
     run in bf16, identical tokens in float32; then training at seq 4096,
     batch 1, remat full, full depth, through ``make_train_step`` (K1 64
     and K1-bwd 32 a step, all on the tensor cores), the peak and one
     profiled step's split;
 35. ``train-whisper-large-v3`` (global batch 2) and
     ``train-phi-3-vision-4.2b`` (global batch 1, at ``PV_LR`` through the
     template's optimizer overrides) at ``scale="full"`` through
     ``run_workflow`` planned for the card's one-card slice (the plan's
     remat and microbatch), 6 steps each: launches by path, the checks
     passing, the peak beside the plan's ``bytes_per_device``, free disk
     checked before each run and each final checkpoint (18.4 and 45.9
     GB) removed after it;
 36. the serving kernels at this slice's shapes against their plain
     versions: K5 with its final state at hymba's prefill (4 rows of
     2080, d_inner 3200, state 16) and K6 with its final state at the
     xLSTM's (8 rows of 512, 4 heads of 384), in both dtypes (the state
     and float32 outputs against float64, as phases 13 and 17), each
     deterministic and with the same output as without its state; K4 at
     phi3.5-moe's serving capacity buffers in bf16: a prefill group's,
     the decode step's and the verify step's (T = SPEC_K + 1), 16 groups
     of 2 rows a slot at decode and verify;
 37. phi3.5-moe at full width, 4 of its 32 layers: 8 requests, two
     exact-length groups (256 and 192 prompt tokens, each admitted whole
     into 4 slots), 16 new tokens, on the fused engine, the paged engine
     (pages of 16) and the paged engine with spec_k SPEC_K (counters
     reset just before each run, read just after: K1, K4, K2 and K3 all
     on the tensor cores), each run's tokens identical to the same
     groups prefilled and decoded (or verified) directly;
 38. hymba-1.5b at full width and depth on the fused engine: a group of
     2080-token prompts (past the window of 2048: the window layers'
     prefill cache a ring) and a group of 2040 whose 32 decode steps
     cross the window's edge, tokens identical to the groups run
     directly; K1 with the window and without, K5 with its state once a
     layer a group; for one request of each group, the prefill's and the
     first decode steps' logits within 2e-2 of max |logit| of the train
     forward at the same positions;
 39. xlstm-125m at full width on the fused engine, groups of 512 and 384
     prompt tokens: tokens identical to the groups run directly, K6 with
     its state once for each of the 9 mLSTM layers a group, on the
     tensor cores;
 40. a serve template for hymba-1.5b, registered in a registry of its
     own as a user registers one, at ``scale="full"`` through
     ``run_workflow`` on the card (8 requests of 8 prompt tokens, under
     the window): completions identical to ``smoke_serve`` called
     directly on the same weights, K5 launched with its state;
 41. the sharded train step on an NCCL world of one (``local_mesh()``,
     started here, after phase 31's host-clock fit, and destroyed after
     phase 44): qwen2-1.5b at full width and depth, seq 4096, batch 2,
     remat full, the plan ``to_runtime_plan`` gives the ``h100-1``
     choice (FSDP on), through ``make_train_artifacts``; 4 steps from the
     same init as the unsharded step (counters reset just before each
     run, read just after: K1 and K1-bwd all on the tensor cores), every
     loss and every parameter leaf bit for bit the unsharded step's (both
     with deterministic algorithms on, as phase 12), no
     leaf copied by the mesh of one, steps 2-4 synced nowhere; the
     median step and peak beside the unsharded ones, and one profiled
     sharded step's NCCL kernels;
 42. the same with ``compress_grads``: the first loss bit for bit the
     uncompressed one's, ``grad_err`` non-zero after step 1, steps 2-4
     synced nowhere, the step's overhead and peak;
 43. the expert-parallel MoE (``moe_impl="shard_map"``) on the mesh of
     one: phi3.5-moe at full width, 2 of 32 layers, seq 4096, batch 2,
     remat full, capacity factor 8: loss, aux and every gradient leaf
     against the scatter path's within phase 24's bf16 bounds, K4's
     launches counted in both (equal, all on the tensor cores); at the
     config's factor, each path's dropped share;
 44. elastic restore: qwen2-1.5b at full width, 4 of 28 layers: a
     sharded step, a save through the layouts, ``elastic_restart`` onto
     ``Placement(h100-8, (8, 1))``'s mesh folded to the card, every leaf
     and the next step bit for bit (deterministic algorithms on); then
     ``train-qwen2-1.5b`` cut at step 3 and resumed through
     ``run_workflow``, whose train stage logs ``reshard``;
 45. the split over ``model`` (``parallel/tensor.py``) installed by the
     sharded step on the same world: phase 41's run with attention split
     by heads and again by the sequence (``seq_shard_attn``), each
     installed split's mode recorded; every loss and every parameter leaf
     bit for bit phase 41's (deterministic algorithms on), the peak
     within 0.05 GB of it, steps 2-4 synced nowhere, K1 and K1-bwd all on
     the tensor cores (a world of one splits nothing: the split
     functions run the unsplit code);
 46. K1 with its LSE and K1-bwd at the split's per-rank shapes, bf16,
     against their plain versions (``TOL``, ``GRAD_TOL``) with their
     times, SDPA's and their bounds: internlm2-20b's rank of a (2, 4)
     mesh (12 query heads over 2 KV heads, S = T 4096) and qwen2-1.5b's
     context-parallel ranks under a ``model`` axis of 8 (512 query rows
     at ``q_offset`` 0, 2048 and 3584 against 4096 keys), where the dK
     and dV rows past each block's last query are exactly zero;
 47. the dry-run (``launch/cells.py``, ``launch/op_stats.py``) in a
     subprocess that touches no CUDA: phase 41's cell (qwen2-1.5b at full
     width and depth, seq 4096, batch 2, remat full, the ``h100-1``
     plan) on a ``(1, 1)`` mesh over a fake world of one, and the
     16×16 qwen2-1.5b ``train_4k`` cell over a fake world of 256 (its
     wall time, per-rank FLOPs, peak and collective bytes); then that
     step on the card on an NCCL world of one, a warm step, and one step
     under the same counter: its FLOPs the dry-run's (rtol 1e-6), the
     dry-run's arguments plus temporaries within 5% of
     ``max_memory_allocated`` over the step, no collective; the dry-run's
     H100 roofline terms, the measured step (median of 3) and the share
     of the card's bf16 peak it reaches;
 48. the families split over ``model`` since the gather went a layer at
     a time (``parallel/fsdp.py``): phi-3-vision, whisper (its encoder
     cut alike) and hymba (layer 0 global, layer 1 a 2048 window) at full
     width and 2 layers, seq 4096, batch 1, remat full, each trained two
     steps by ``make_train_artifacts`` on phase 41's NCCL world of one
     and by the unsharded step from the same init: every loss and every
     parameter leaf bit for bit (deterministic algorithms on), the peak
     within 0.05 GB, K1, K1-bwd, K5 and K5-bwd launched alike; then the
     kernels at the shapes a split rank gives them, bf16, against their
     plain versions with their times and bounds: K5 and K5-bwd at hymba's
     800 of 3200 channels (a ``model`` axis of 4), and K1 with its LSE and
     K1-bwd on whisper's non-causal encoder at a sequence-split rank (375
     of 1500 frames at ``q_offset`` 375);
 49. the dense decoders' serving split over ``model`` (``serve/
     sharded.py``), on one card: K1 at glm4-9b's split prefill rank of
     ``prefill_32k`` on 16x16 (bf16, B 2, S = T 32768, causal, 2 query
     heads reading 1 KV head) timed with SDPA's time and its bound, and
     held against its plain version at S = T 4096; then qwen2-1.5b at
     full width in bf16 (8 slots, a cache of 32768, prompts of 4096, 16
     decode steps) with its cache read whole and read in 16 blocks of
     2048 whose partials ``merge_partials`` joins (the arithmetic of the
     decode on a cache split over 16 ranks), fed the same tokens: the
     logits within ``TOL``'s bf16 tolerance, finite, of the expected
     shape; and the same at 4 layers in float32, each run choosing its own
     greedy tokens: identical.  The served runs' K1 launches join K1's
     count;
 50. the MoE decoders' and phi-3-vision's serving split over ``model``
     (the experts held split: each rank routes all its tokens, runs its
     experts' slots and the partial outputs are summed), on one card: K4
     at a rank's local experts of the 16x16 cells (qwen3-moe decode 8
     experts x 64 rows, phi3.5-moe decode 1 x 16, qwen3-moe prefill 8 x
     5120, phi3.5-moe prefill 1 x 10240; D 4096, the gate/up product),
     bf16, each against its plain version (``GMM_TOL``), timed with
     ``torch.bmm``'s time and its bound; K1 at phi-3-vision's split
     prefill rank (B 2, S = T 32768, 2 heads of 96) against its plain
     version at S = T 4096, timed with SDPA's; then phi3.5-moe at full
     width, 2 layers, bf16, phase 49's slots, cache, prompts and steps,
     with its 16 experts computed as 16 blocks whose partial outputs are
     summed (``moe.expert_blocks``), against the whole layer, fed the
     same tokens: the logits within ``TOL``'s bf16 tolerance; and the
     same in float32, each run choosing its own greedy tokens:
     identical.  The served runs' K4 and K1 launches join their kernels'
     counts;
 51. whisper's, hymba's and the xLSTM's serving split over ``model``,
     on one card: K5 with its final state at hymba's split prefill rank
     of ``prefill_32k`` on 16x16 (B 2, S 32768, 200 of 3200 channels),
     K1 at whisper's decoder prefill rank (B 2, S = T 32768, its 20
     heads of 64 unsplit) against its plain version at S = T 4096 and
     timed with SDPA's, and K6 with its final state at the xLSTM's
     prefill rank (B 2, 4 heads, S 32768, D = DV 384), bf16, each
     against its plain version and timed beside its bound; then hymba at
     full width cut to 4 layers (layer 0 global) and whisper at full
     width cut to 4 + 4 layers, 4 slots, prompts of 2560 (past hymba's
     window, so its rings wrap), phase 49's cache and steps, each global
     or self-attention cache read whole and read in 16 merged blocks: in
     bf16 each step from the same cache and token, the logits within
     ``TOL``'s bf16 2e-2 of their max |logit|; in float32 over 16 steps,
     each run choosing its own greedy tokens: identical.  The served
     runs' K1 and K5 launches join their kernels' counts.

The second-to-last lines are the kernel table (JSON) and the
``nvidia-smi`` name/power line; the last line is the result JSON.
Weights are random, from a seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC)
# deterministic cuBLAS for phase 12: read when cuBLAS first initialises,
# so set before any CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention.bias import causal_lower_right  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.core import (CATALOG, REGISTRY,  # noqa: E402
                              CalibrateStage, ExploreStage, ProvenanceStore,
                              ResourceIntent, StageGraph, build_catalog,
                              calibrate, catalog_generation, plan,
                              register_card, run_workflow, unregister_card)
from repro_torch.core.explore import ExploreSpec, derived_shape  # noqa: E402
from repro_torch.core.graph import Placement  # noqa: E402
from repro_torch.core.planner import to_runtime_plan  # noqa: E402
from repro_torch.ft import elastic_restart  # noqa: E402
from repro_torch.ft.failures import FailureSchedule  # noqa: E402
from repro_torch.launch.mesh import local_mesh  # noqa: E402
from repro_torch.parallel import shard_tree, tensor  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.kernels import build, flash_attention, ops  # noqa: E402
from repro_torch.kernels import flash_attention_bwd, mlstm_scan  # noqa: E402
from repro_torch.kernels import paged_attention, paged_attention_mq  # noqa: E402
from repro_torch.kernels import moe_gmm, ref, ssm_scan  # noqa: E402
from repro_torch.kernels.timing import (cold_copies,  # noqa: E402
                                        launch_floor_ms, time_ms)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm, moe, recurrent, speculate  # noqa: E402
from repro_torch.serve import Request, ServeEngine, smoke_serve  # noqa: E402
from repro_torch.train import (OptimizerConfig, Plan,  # noqa: E402
                               init_train_state, make_grad_fn,
                               make_train_artifacts, make_train_step)
from repro_torch.train.optimizer import global_norm  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

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
# the serve workflow's smoke knobs (run_workflow's defaults): 8 requests
# of 8 prompt tokens, 4 slots, max_seq 32 + 64
WF_SMOKE_BATCH, WF_SMOKE_SEQ = 4, 32
# training: the train_4k shape's length, its global batch of 256 cut to 2
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_MICROBATCH = 4096, 2, 4, 1
# K1-bwd's float32 gradients: the reference's own tolerance for its flash
# VJP against plain autodiff (sums over whole sequences in other orders)
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# kernel path vs plain path, one step at full width (bf16 compute)
LOSS_REL_BOUND, GNORM_REL_BOUND = 1e-2, 5e-2
# xlstm-125m training: train_4k's length, its global batch of 256 cut to 8
XL_SEQ, XL_BATCH, XL_STEPS, XL_MICROBATCH = 4096, 8, 4, 1
# K6-bwd against its plain version: max |diff| over each gradient's max
# |g| (the same algorithm summed in other orders; bf16 outputs rounded)
MLSTM_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the chunk length phase 13's bounds count the work at: a property of the
# chunkwise algorithm, not of the kernel that runs it (the FMA path's 32
# rows; the tensor-core path's 64), so the bound row stays the same
# whatever implements K6
K6_BOUND_CHUNK = 32
# device kernels counted as GEMMs in a profiled step's split (cuBLAS and
# CUTLASS names)
GEMM_KERNELS = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")
# hymba-1.5b training: train_4k's length, its global batch of 256 cut to 2
# (batch 2 peaked at 74.5 GB on an H100 80GB, under the 76 GB kept as
# headroom; batch 1 at 49.4 GB)
HY_SEQ, HY_BATCH, HY_STEPS = 4096, 2, 4
# kernel path vs plain path at the 2-layer cut in float32 compute: every
# gradient leaf within this share of its max |g| (10x the CPU parity
# bound: sums over 4096 positions in other orders)
HY_LEAF_BOUND = 1e-3
# SSM parameters moved off their init for that comparison, so that the
# scan shapes the gradients: (name, mean, std)
HY_MOVED = (("ssm_A_log", 0.0, 0.5), ("ssm_b_dt", 1.0, 1.0),
            ("ssm_D", 0.0, 1.0), ("ssm_conv_w", 0.0, 0.3),
            ("ssm_w_B", 0.0, 0.1), ("ssm_w_C", 0.0, 0.1),
            ("ssm_w_dt1", 0.0, 0.1), ("ssm_w_dt2", 0.0, 0.1))
# K5-bwd against its plain version: max |diff| over each gradient's max |g|
SSM_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# exponentials a second on the special-function units: 16 a clock on each
# of the 132 SMs at the 1980 MHz boost clock (H100 SXM)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# the tensor-core building blocks K1, K1-bwd, K4, K6 and K6-bwd include
# (wgmma, TMA, mbarriers), and K6's and K6-bwd's shared chunk walk, named
# beside their sources in the kernel table
HOPPER_COMMON = "src/repro_torch/kernels/csrc/hopper_common.cuh"
MLSTM_TC = "src/repro_torch/kernels/csrc/mlstm_tc.cuh"
SSM_COMMON = "src/repro_torch/kernels/csrc/ssm_common.cuh"
# K2's and K3's shared page walk (split-KV, TMA through the page table,
# wgmma), and its merge kernel
PAGED_COMMON = "src/repro_torch/kernels/csrc/paged_common.cuh"
# the train workflow at full width planned for the card (phase 30): the
# global batches of train_4k one card takes (batch 256 has no plan on one
# card: the planner's microbatch grid stops at 4), and the steps a run of
# phase 35 takes (the loss_decreased check needs 4)
CARD_BATCHES, CARD_STEPS = (2, 4), 6
# the steps of phase 30's runs, whose median step after the first the
# calibration fits: 8 timed, so that a few slow steps (those just after
# the first, or a host busy elsewhere) do not move the median; short of
# the template's checkpoint_every of 10, whose background write slows the
# steps after it
CARD_FIT_STEPS = 9
# the calibration fit's relative residual on its samples (phase 31)
CARD_FIT_RESIDUAL = 0.15
# phi3.5-moe training: train_4k's length, its global batch of 256 cut to
# 2, its 32 layers cut to 2 (2.86 B parameters: 45.8 GB of float32
# weights, gradients and moments)
MOE_SEQ, MOE_BATCH, MOE_STEPS, MOE_LAYERS = 4096, 2, 4, 2
# K4 against its plain version: bf16 abs+rel, float32 over the output's
# max |y| (sums of up to 6400 products in other orders)
GMM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# kernel path vs plain path of one MoE step in float32: every gradient
# leaf within this share of its max |g| (as hymba's phase 20)
MOE_LEAF_BOUND = 1e-3
# serving the MoE decoders, hymba and the xLSTM (phases 36-40): 4 slots,
# 8 requests in two exact-length groups of 4.  phi3.5-moe cut to 4 of its
# 32 layers (5.46 B parameters: 10.9 GB of bf16 serving weights, 21.8 GB
# of float32 master weights at init); max_seq a page multiple past the
# longer prompt, its budget and a verify pass's SPEC_K rows
SV_SLOTS, SV_REQUESTS = 4, 8
MOE_SV_LAYERS, MOE_SV_PROMPTS, MOE_SV_NEW = 4, (256, 192), 16
MOE_SV_MAX_SEQ = 288
# hymba at full depth: a group of prompts past the window of 2048 (the
# prefill lays the window layers out as a ring) and a group whose decode
# crosses the window's edge (positions 2040 .. 2071)
HY_SV_PROMPTS, HY_SV_NEW, HY_SV_MAX_SEQ = (2080, 2040), (16, 32), 2096
# the decode steps held against the train forward, and the bound on
# max |decode - forward| / max |forward logit| by compute dtype: bf16 the
# full-width bound of phase 6 (activations rounded at other points by the
# decode reads and K1, K5 through 32 layers); float32 where the mask's
# work shows (an empty ring slot attended to moves the logits by about
# 15% of their max at reduced width, ROADMAP §3)
HY_SV_FWD_STEPS = 4
HY_SV_FWD_BOUND = {"bfloat16": LOGIT_REL_BOUND, "float32": 1e-3}
# xlstm-125m at full width: groups of 512 and 384 prompt tokens
XL_SV_PROMPTS, XL_SV_NEW, XL_SV_MAX_SEQ = (512, 384), 16, 528


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, dtype, tol=None) -> float:
    err = (got.float() - want.float()).abs()
    tol = (TOL[dtype] if tol is None else tol) * (1 + want.float().abs())
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


def _path(tc_launches: int) -> str:
    """The path one launch of K1, K1-bwd, K4, K6 or K6-bwd took, by its
    tensor-core count."""
    return "tensor-cores" if tc_launches == 1 else "fma"


def _k1_case(name, dtype, B, S, T, H, KH, D, window, gen, tag="3 K1"):
    dev = torch.device("cuda")
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
    n_tc = flash_attention.tc_launches
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True,
                                               window=window)
    path = _path(flash_attention.tc_launches - n_tc)
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
    log(f"[{tag}] {name} {str(dtype)[6:]} B={B} S={S} T={T} H={H} KH={KH} "
        f"D={D} window={window}: path={path} max_abs_err={err:.3g} (tol "
        f"{TOL[dtype]:g} abs+rel) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} ms/library_ms={ms / lib_ms:.2f} "
        f"bound_ms={bms:.5f} ({by})")
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


def _paged_table(B, T, page, max_pages, base, P, rng):
    """A table of distinct random pool pages (never the null page 0) for
    the positions each slot's furthest row sees, -1 past them."""
    seen = np.minimum(base + T - 1, max_pages * page)
    table = np.full((B, max_pages), -1, np.int32)
    free = rng.permutation(np.arange(1, P)).astype(np.int32)
    at = 0
    for b in range(B):
        n = -(-int(seen[b]) // page)
        table[b, :n] = free[at:at + n]
        at += n
    return table, seen


def _paged_path(mod, n0) -> str:
    """The path a K2 or K3 launch took, by its counters' moves since n0."""
    tc, fma, merge = (getattr(mod, k) - n for k, n in zip(
        ("tc_launches", "fma_launches", "merge_launches"), n0))
    assert tc + fma == 1, (tc, fma)
    return ("tensor-cores" if tc else "fma") + (" +merge" if merge else "")


def _paged_counts(mod):
    return (mod.tc_launches, mod.fma_launches, mod.merge_launches)


def _paged_case(kernel, name, dtype, B, T, KH, G, D, page, max_pages, lens,
                gen, rng, cold=False, long=False, phase=None):
    """K2 (T = 1, lens = kv_len) or K3 (lens = base_len) against its plain
    version on random inputs; its time hot (and, with ``cold``, with the
    pools cold: a rotation through copies that together hold twice the
    L2), the plain version's, and the bound.  ``long`` times the plain
    version between events (its gather of a long table is too large for
    a graph of several calls)."""
    dev = torch.device("cuda")
    P = 1 + B * max_pages
    q = torch.randn((B, T, KH * G, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((KH, P, page, D), generator=gen, device=dev).to(dtype)
    base = np.asarray(lens, np.int32)
    table, seen = _paged_table(B, T, page, max_pages, base, P, rng)
    tt = torch.from_numpy(table).to(dev)
    tb = torch.from_numpy(base).to(dev)
    mod, fn, plain = ((paged_attention, paged_attention.paged_attention_cuda,
                       paged_attention.plain) if kernel == "K2" else
                      (paged_attention_mq,
                       paged_attention_mq.paged_attention_mq_cuda,
                       paged_attention_mq.plain))
    n0 = _paged_counts(mod)
    got = fn(q, kp, vp, tt, tb)
    path = _paged_path(mod, n0)
    want = plain(q, kp, vp, tt, tb)
    torch.cuda.synchronize()
    err = max_err(got, want, dtype)
    extra = ""
    if kernel == "K3" and T == 1:  # one row is K2 on the same inputs
        k2 = paged_attention.paged_attention_cuda(q, kp, vp, tt, tb)
        torch.cuda.synchronize()
        assert torch.equal(got, k2), "K3 at T = 1 is not K2 bit for bit"
        extra = " vs_K2=bit-identical"
    del want
    ms = time_ms(lambda: fn(q, kp, vp, tt, tb))
    if long:
        plain_ms = time_events_ms(lambda: plain(q, kp, vp, tt, tb), reps=3)
    else:
        plain_ms = time_ms(lambda: plain(q, kp, vp, tt, tb), reps=5, inner=3)
    # no single PyTorch call computes a read through a page table
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, path=path,
             library_ms=None)
    if cold:
        n = cold_copies(2 * kp.numel() * kp.element_size())
        pools = [(kp.clone(), vp.clone()) for _ in range(n)]
        r["ms_cold"] = time_ms(lambda i: fn(q, *pools[i], tt, tb), cold=n)
        del pools
        extra += f" ms_cold={r['ms_cold']:.5f} ({n} pool copies)"
    size = torch.finfo(dtype).bits // 8
    # q and out once, the K and V each slot's rows can see once, the int32
    # table and lengths; FLOPs 4 D per visible (row, key) pair
    nbytes = (size * (2 * B * T * KH * G * D + 2 * int(seen.sum()) * KH * D)
              + 4 * (B * max_pages + B))
    rows_seen = np.minimum(base[:, None] + np.arange(T)[None],
                           max_pages * page)
    flops = 4.0 * D * KH * G * int(rows_seen.sum())
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, flops, peak)
    shown = (base.tolist() if B <= 8 else f"{B} x {int(base[0])}")
    phase = phase or ("4 K2" if kernel == "K2" else "7 K3")
    what = "kv_len" if kernel == "K2" else "base_len"
    log(f"[{phase}] {name} {str(dtype)[6:]} B={B}" +
        (f" T={T}" if kernel == "K3" else "") + f" KH={KH} G={G} D={D} "
        f"page={page} max_pages={max_pages} {what}={shown}: path={path} "
        f"max_abs_err={err:.3g} (tol {TOL[dtype]:g} abs+rel){extra} "
        f"ms={ms:.5f} plain_ms={plain_ms:.4f} library_ms=null "
        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    del q, kp, vp, got
    torch.cuda.empty_cache()
    return r


def _long_cases(kernel, T):
    """The shapes where bytes decide, qwen2-1.5b's KV heads, group, head
    dim and pages: one layer of decode_32k (B 128 at 32768 positions), and
    B 8 at 32768 (where the split has to fill the card); bf16, and float32
    at B 8 alone (to spare memory and time).  Drawn from their own
    generators."""
    lgen = torch.Generator(device="cuda").manual_seed(21)
    lrng = np.random.default_rng(21)
    out = {}
    for name, B, dtypes in (("decode_32k", 128, (torch.bfloat16,)),
                            ("batch8-32k", 8, (torch.bfloat16,
                                               torch.float32))):
        for dtype in dtypes:
            r = _paged_case(kernel, name, dtype, B, T, 2, 6, 128, PAGE,
                            32768 // PAGE, [32768 - (T - 1)] * B, lgen,
                            lrng, long=True)
            if dtype == torch.bfloat16:
                assert r["path"].startswith("tensor-cores"), r["path"]
                out[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                 bound_ms=r["bound_ms"],
                                 bound_by=r["bound_by"], path=r["path"],
                                 max_abs_err=r["max_abs_err"])
    return out


def phase_k2(gen) -> dict:
    rng = np.random.default_rng(0)
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        # main path: the paged decode batch at its live lengths (prompt 64
        # + up to 31 decoded tokens; max_seq 96 -> 6 table entries per slot)
        r = _paged_case("K2", "main-path", dtype, MAX_BATCH, 1, 2, 6, 128,
                        PAGE, MAX_SEQ // PAGE, [65, 70, 80, 95, 96, 64, 81,
                                                90], gen, rng,
                        cold=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            assert r["path"] == "tensor-cores", r["path"]
            main = r
        # long cache, ragged lengths with exact page boundaries and a
        # one-token slot; -1 past each length
        _paged_case("K2", "long", dtype, 8, 1, 2, 6, 128, PAGE, 64,
                    [1, 16, 17, 512, 1024, 1000, 333, 32], gen, rng)
    main["launch_floor_ms"] = launch_floor_ms()
    log(f"[4 K2] launch floor (an empty kernel in the same kind of graph): "
        f"{main['launch_floor_ms']:.5f} ms")
    main["long"] = _long_cases("K2", 1)
    return main


# ---------------------------------------------------------------------------
def _reset_paged_counters(*mods) -> None:
    for mod in mods:
        mod.launches = mod.tc_launches = mod.fma_launches = 0
        mod.merge_launches = 0


def _paged_paths(mod) -> dict:
    """A K2 or K3 wrapper's launches by path since the reset; every bf16
    launch of the serving paths takes the tensor cores."""
    paths = {"tensor-cores": mod.tc_launches, "fma": mod.fma_launches,
             "merged": mod.merge_launches}
    assert mod.tc_launches == mod.launches > 0, paths
    return paths


def phase_serve_paged(model, params, cfg) -> dict:
    flash_attention.launches = 0
    _reset_paged_counters(paged_attention)
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
    log(f"[5 serve paged] K2 launches by path: "
        f"{_paged_paths(paged_attention)}")
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


def _engine_group_tokens(model, params, cfg, engine):
    """Greedy tokens of one admission group (the smoke burst's first
    MAX_BATCH requests) on the fused or the legacy engine."""
    eng = ServeEngine(model, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                      engine=engine)
    done, _ = _burst(eng, cfg.vocab_size, MAX_BATCH)
    return {c.uid: c.tokens for c in done}


def _group_prompts(cfg) -> dict:
    """The smoke burst's first MAX_BATCH prompts, by uid."""
    rng = np.random.default_rng(0)
    return {uid: rng.integers(1, cfg.vocab_size, PROMPT_LEN)
            for uid in range(MAX_BATCH)}


def _near_tie_divergences(tag, model, params, base, other, prompts,
                          extras=None) -> int:
    """Requests whose greedy tokens differ between two runs in float32:
    each divergence is reported and must sit at a near-tie of the
    target (top-2 margin under 1e-3 of max |logit|, after the request's
    prompt and extra inputs, both by uid); returns how many requests are
    token-identical."""
    for uid in base:
        a, b = base[uid], other[uid]
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        margin = _top2_margin(model, params, prompts[uid], a[:i],
                              (extras or {}).get(uid))
        log(f"[{tag}] uid={uid} diverges at token {i}: top-2 margin "
            f"{margin:.3g} of max|logit|")
        assert margin < 1e-3, (uid, i, margin)
    return sum(base[u] == other[u] for u in base)


def phase_serve_legacy(model, params, cfg) -> int:
    """The legacy engine on the serving workload (counters reset just
    before, read just after): K1 once a request a layer (each request
    prefilled alone; its decode reads are the plain dense ones), the
    full (B, V) logits to the host each decode step, host-clock
    tok/s beside the fused engine's on the same burst; then greedy
    identity with the fused engine in float32 compute on one admission
    group, and the bf16 agreeing share.  Returns K1's launches."""
    _reset_k1_counters()
    eng = ServeEngine(model, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                      engine="legacy")
    done, wall = _burst(eng, cfg.vocab_size)
    k1, k1_tc = flash_attention.launches, flash_attention.tc_launches
    toks = sum(len(c.tokens) for c in done)
    assert len(done) == NUM_REQUESTS
    assert all(1 <= len(c.tokens) <= MAX_NEW for c in done)
    assert k1 == k1_tc == NUM_REQUESTS * cfg.num_layers, (k1, k1_tc)
    assert eng.d2h_elems == eng.d2h_transfers * MAX_BATCH * cfg.vocab_size
    log(f"[6 serve legacy] requests={len(done)} tokens={toks} wall_s="
        f"{wall:.3f} tok_per_s={toks / wall:.1f} (first run) decode steps="
        f"{eng.d2h_transfers} d2h_elems a step="
        f"{eng.d2h_elems // eng.d2h_transfers} (B x V = {MAX_BATCH} x "
        f"{cfg.vocab_size}; fused moves {MAX_BATCH}) K1 launches={k1} (one a "
        f"request a layer: {NUM_REQUESTS} x {cfg.num_layers}, tensor-cores "
        f"{k1_tc})")
    # warm, in turns: legacy, fused, legacy, fused on the same burst
    for engine in ("legacy", "fused") * 2:
        d, w = _burst(ServeEngine(model, params, max_batch=MAX_BATCH,
                                  max_seq=MAX_SEQ, engine=engine),
                      cfg.vocab_size)
        n = sum(len(c.tokens) for c in d)
        log(f"[6 serve legacy] warm {engine}: tokens={n} wall_s={w:.3f} "
            f"tok_per_s={n / w:.1f}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.serving_params(model32.init(seed=0))
    base = _engine_group_tokens(model32, params32, cfg32, "fused")
    legacy = _engine_group_tokens(model32, params32, cfg32, "legacy")
    same = _near_tie_divergences("6 legacy f32", model32, params32, base,
                                 legacy, _group_prompts(cfg32))
    log(f"[6 legacy f32] {same}/{len(base)} requests token-identical on "
        f"the legacy and the fused engine")
    del model32, params32
    torch.cuda.empty_cache()
    base = _engine_group_tokens(model, params, cfg, "fused")
    legacy = _engine_group_tokens(model, params, cfg, "legacy")
    pairs = [(x, y) for u in base for x, y in zip(base[u], legacy[u])]
    agree = sum(x == y for x, y in pairs) / len(pairs)
    log(f"[6 legacy bf16] share of tokens that agree between the legacy "
        f"and the fused engine: {agree:.4f} ({len(pairs)} positions)")
    return k1


# ---------------------------------------------------------------------------
def phase_k3(gen) -> dict:
    rng = np.random.default_rng(1)
    main = None
    mp = -(-SPEC_MAX_SEQ // PAGE)  # 7 table entries per slot
    lens = [65, 70, 80, 95, 96, 64, 81, 90]
    for dtype in (torch.bfloat16, torch.float32):
        # main path: the verify batch of the speculative run (T = spec_k + 1)
        r = _paged_case("K3", "main-path", dtype, MAX_BATCH, SPEC_K + 1, 2,
                        6, 128, PAGE, mp, lens, gen, rng,
                        cold=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            assert r["path"] == "tensor-cores", r["path"]
            main = r
        _paged_case("K3", "long", dtype, 8, 5, 2, 6, 128, PAGE, 64,
                    [1, 16, 17, 512, 1020, 1000, 333, 32], gen, rng)
        # rows ending exactly on page edges, and base_len 1
        _paged_case("K3", "page-edges", dtype, 8, 5, 2, 6, 128, PAGE, 8,
                    [1, 12, 16, 17, 28, 32, 48, 64], gen, rng)
        # 80 rows per block (glm4-9b's G = 16 at spec_k = 4)
        _paged_case("K3", "G=16", dtype, 4, 5, 2, 16, 128, PAGE, 8,
                    [1, 33, 64, 100], gen, rng)
        _paged_case("K3", "T=1", dtype, MAX_BATCH, 1, 2, 6, 128, PAGE, mp,
                    lens, gen, rng)
    # past one block's 128 rows at D = 128: row tiles, beside the largest
    # one-tile case (glm4-9b, G = 16, spec_k 7); drawn from their own
    # generators, so that the phases after this one see the inputs they
    # saw before these cases existed
    tgen = torch.Generator(device="cuda").manual_seed(7)
    trng = np.random.default_rng(7)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, G in (("128 rows (G=16 spec_k=7)", 8, 16),
                           ("144 rows (G=16 spec_k=8)", 9, 16),
                           ("272 rows (G=16 spec_k=16)", 17, 16),
                           ("150 rows (G=6 spec_k=24)", 25, 6)):
            rows = build.library().repro_paged_attention_mq_tile_rows(
                T * G, 128, PAGE, int(dtype == torch.bfloat16))
            log(f"[7 K3] {name} {str(dtype)[6:]}: {-(-T * G // rows)} row "
                f"tile(s) of {rows}")
            _paged_case("K3", name, dtype, 4, T, 2, G, 128, PAGE, 12,
                        [1, 33, 64, 150], tgen, trng)
    main["launch_floor_ms"] = launch_floor_ms()
    main["long"] = _long_cases("K3", SPEC_K + 1)
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


def _top2_margin(model, params, prompt, prefix, extra=None) -> float:
    """The target's top-2 logit margin after ``prompt + prefix`` (with the
    request's extra inputs), as a share of max |logit|."""
    seq = np.concatenate([prompt, np.asarray(prefix, np.int64)])
    tokens = torch.tensor(seq[None], dtype=torch.int32, device="cuda")
    if extra:
        extra = {k: torch.from_numpy(v[None]).cuda() for k, v in extra.items()}
    logits, _ = model.prefill(params, tokens, extra)
    top = torch.topk(logits[0].float(), 2).values
    return float((top[0] - top[1]) / logits[0].float().abs().max())


def phase_serve_spec(model, params, cfg) -> int:
    # main path: the paged engine's speculative decode with the n-gram
    # proposer, counters reset just before and read just after
    flash_attention.launches = 0
    _reset_paged_counters(paged_attention, paged_attention_mq)
    eng = _spec_engine(model, params, SPEC_K)
    done, wall = _burst(eng, cfg.vocab_size)
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in
                (flash_attention, paged_attention, paged_attention_mq)}
    log(f"[8 serve spec] K3 launches by path: "
        f"{_paged_paths(paged_attention_mq)}" + (
            f"; K2: {_paged_paths(paged_attention)}"
            if paged_attention.launches else ""))
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
    same = _near_tie_divergences("8 greedy f32", model32, params32, base,
                                 spec, _group_prompts(cfg32))
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
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, PROMPT_LEN)
               for _ in range(MAX_BATCH)]
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


# ---------------------------------------------------------------------------
def time_events_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn`` between CUDA events, median of
    ``reps`` (for calls a CUDA graph cannot capture, like an autograd
    backward; at milliseconds per call the launch overhead is noise)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _events_ms(fn):
    """``(fn(), its device ms between CUDA events)``: one call timed, for
    a plain version whose check already calls it once."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _live_mask(S, T, window, q_offset, dev, causal=True):
    qpos = q_offset + torch.arange(S, device=dev)
    kpos = torch.arange(T, device=dev)
    live = (qpos[:, None] >= kpos[None, :] if causal
            else torch.ones((S, T), dtype=torch.bool, device=dev))
    if window:
        live &= qpos[:, None] - kpos[None, :] < window
    return live


def _k1_train_case(name, dtype, B, S, T, H, KH, D, window, q_offset, gen,
                   phase=9, causal=True, unseen_zero=False):
    dev = torch.device("cuda")
    q, do = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, T, KH, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    n_tc = (flash_attention.tc_launches, flash_attention_bwd.tc_launches)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, with_lse=True,
                                                    **mask)
    want_out, want_lse = ref.attention_fwd(q, k, v, **mask)
    torch.cuda.synchronize()
    err_fwd = max(max_err(out, want_out, dtype), max_err(lse, want_lse, dtype))
    got = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                       **mask)
    paths = (_path(flash_attention.tc_launches - n_tc[0]),
             _path(flash_attention_bwd.tc_launches - n_tc[1]))
    want = ref.attention_bwd(q, k, v, out, lse, do, **mask)
    torch.cuda.synchronize()
    err = max(max_err(g, w, dtype, GRAD_TOL[dtype]) for g, w in zip(got, want))
    del want
    if unseen_zero:
        # the keys past the last query: no query sees them, so K1-bwd
        # must write exact zeros there (its outputs start as torch.empty)
        assert causal and not window, name
        unseen = T - min(T, q_offset + S)
        tail = [x[:, T - unseen:] for x in got[1:]]
        assert all(int(torch.count_nonzero(x)) == 0 for x in tail), \
            f"{name}: dK/dV rows past the last query are not zero"
    again = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                         **mask)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K1-bwd is not deterministic"
    fwd_ms = time_ms(lambda: flash_attention.flash_attention_cuda(
        q, k, v, with_lse=True, **mask), reps=5, inner=3)
    ms = time_ms(lambda: flash_attention_bwd.flash_attention_bwd_cuda(
        q, k, v, out, lse, do, **mask), reps=5, inner=3)
    plain_ms = time_ms(lambda: ref.attention_bwd(q, k, v, out, lse, do,
                                                 **mask), reps=3, inner=1)
    fplain_ms = time_ms(lambda: ref.attention_fwd(q, k, v, **mask), reps=3,
                        inner=1)
    # the yardstick: SDPA's backward through autograd, its forward done
    # beforehand (never used by the port), in its (B, H, S, D) layout.
    # Causal with no window and keys up to the last query: SDPA on that
    # live key prefix, causal aligned at its lower right (is_causal when
    # the queries start at key 0), which keeps a 16-bit call on its flash
    # backend; otherwise the dense mask
    live = _live_mask(S, T, window, q_offset, dev, causal)
    kv_end = T
    if not causal and not window:
        sdpa = {}
    elif causal and not window and q_offset + S <= T and (
            not q_offset or dtype != torch.float32):
        kv_end = q_offset + S
        sdpa = (dict(is_causal=True) if not q_offset else
                dict(attn_mask=causal_lower_right(S, kv_end)))
    else:
        sdpa = dict(attn_mask=live)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x[:, :kv_end].transpose(1, 2).detach().requires_grad_()
              for x in (k, v))
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), enable_gqa=True, **sdpa),
        reps=5, inner=3)
    o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa)
    max_err(o.detach().transpose(1, 2), want_out, dtype)  # the same function
    del want_out
    dot = do.transpose(1, 2)
    lib_ms = time_events_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True))
    del o
    pairs = int(live.sum())
    # the keys some query sees: K and V are read only there (dK and dV
    # are written over all T, zeros past them)
    seen = int(live.any(0).sum())
    size = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    # backward: q, out, dO, the seen keys of k and v, and lse read once,
    # dq, dk, dv written once; five products of 2 D flops per live
    # (row, key) pair
    nbytes = size * (4 * B * S * H * D + 2 * B * (seen + T) * KH * D) \
        + 4 * B * S * H
    bms, by = bound_ms(nbytes, 10.0 * B * H * D * pairs, peak)
    # forward with the LSE: q and the seen keys of k, v read, out and lse
    # written
    fbytes = size * (2 * B * S * H * D + 2 * B * seen * KH * D) \
        + 4 * B * S * H
    fbms, fby = bound_ms(fbytes, 4.0 * B * H * D * pairs, peak)
    log(f"[{phase} K1+lse] {name} {str(dtype)[6:]} B={B} S={S} T={T} H={H} "
        f"KH={KH} D={D} causal={causal} window={window} q_offset={q_offset}: "
        f"path={paths[0]} "
        f"max_abs_err={err_fwd:.3g} (tol {TOL[dtype]:g} abs+rel, out and lse) "
        f"ms={fwd_ms:.4f} plain_ms={fplain_ms:.4f} library_ms="
        f"{lib_fwd_ms:.4f} ms/library_ms={fwd_ms / lib_fwd_ms:.2f} "
        f"bound_ms={fbms:.5f} ({fby})")
    log(f"[{phase} K1-bwd] {name} {str(dtype)[6:]}: path={paths[1]} "
        f"max_abs_err={err:.3g} (tol {GRAD_TOL[dtype]:g} abs+rel, dq dk dv) "
        f"deterministic=True ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} ms/library_ms={ms / lib_ms:.2f} "
        f"bound_ms={bms:.5f} ({by})"
        + (f"; dK, dV exactly 0 on the {unseen} keys past the last query"
           if unseen_zero else ""))
    assert dtype != torch.bfloat16 or paths == ("tensor-cores",) * 2 or \
        not flash_attention.tensor_core_path(dtype, D), (name, paths)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                fwd=dict(max_abs_err=err_fwd, ms=fwd_ms, plain_ms=fplain_ms,
                         bound_ms=fbms, bound_by=fby, library_ms=lib_fwd_ms))


def phase_k1_train(gen) -> tuple:
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, T, window, q_offset in (
                ("train-shape", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 0, 0),
                ("ragged", 1, 1000, 1000, 0, 0),
                ("window", 1, 1024, 1024, 64, 0),
                ("offset", 1, 512, 1536, 0, 1024)):
            r = _k1_train_case(name, dtype, B, S, T, 12, 2, 128, window,
                               q_offset, gen)
            if name == "train-shape" and dtype == torch.bfloat16:
                main = r
                main_fwd = main.pop("fwd")
            torch.cuda.empty_cache()
    return main, main_fwd


# K1's and K1-bwd's kernels by name, both paths: the tensor cores'
# (flash_fwd_tc_kernel, dkdv_tc_kernel, dq_tc_kernel) and the FMAs'
K1_KINDS = {"K1 forward": ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
            "K1-bwd": ("dkdv_tc_kernel", "dq_tc_kernel", "dkdv_kernel",
                       "dq_kernel", "delta_kernel")}


def _reset_k1_counters() -> None:
    for mod in (flash_attention, flash_attention_bwd):
        mod.launches = mod.tc_launches = mod.fma_launches = 0


def _k1_paths(cfg, want: int) -> dict:
    """K1's and K1-bwd's launches by path since the counters were reset,
    asserted: all ``want`` of each on the path ``cfg``'s dtype and head
    dim take (the tensor cores in bf16 at every config's head dim)."""
    paths = {f"{mod.__name__.rsplit('.', 1)[1]}_{p}": getattr(mod,
                                                            f"{p}_launches")
             for mod in (flash_attention, flash_attention_bwd)
             for p in ("tc", "fma")}
    tc = flash_attention.tensor_core_path(getattr(torch, cfg.dtype),
                                          cfg.head_dim)
    for mod in ("flash_attention", "flash_attention_bwd"):
        assert (paths[f"{mod}_tc"], paths[f"{mod}_fma"]) == (
            (want, 0) if tc else (0, want)), (paths, want, tc)
    return paths


def _device_split(prof, kinds=None):
    """Device ms of one profiled step by kind of kernel (K1's by default),
    and by kernel name (the names cut to 60 characters)."""
    kinds = dict(kinds or K1_KINDS, GEMMs=GEMM_KERNELS)
    split = {k: 0.0 for k in kinds}
    split["rest"] = 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "rest")
        ms = e.time_range.elapsed_us() / 1e3
        split[kind] += ms
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
    return split, by_name


# what ``torch.cuda.set_sync_debug_mode("warn")`` says at each operation
# that waits for the card
SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync_sites(fn):
    """``(fn(), the Python lines where fn waited for the card)``, as the
    sync debug mode reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if SYNC_WARNING in str(w.message)]


def _unsynced_steps(step, state, batches):
    """``TRAIN_STEPS`` steps of ``step``, each timed to its loss read; from
    the second on, the step itself must wait for the card nowhere (a
    scalar made on the host, a pageable copy, or a read of the device
    would drain the queue, and the host's dispatch would then add to the
    device's time instead of running ahead of it).  First the check is
    shown to see such a wait: a scalar copied from the host."""
    _, control = _sync_sites(lambda: torch.tensor(1.0, device="cuda"))
    assert control, "the sync debug mode saw no host-to-device copy"
    losses, walls, syncs = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if i:
            (state, metrics), sites = _sync_sites(
                lambda s=state, b=batches[i]: step(s, b))
            syncs += sites
        else:
            state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
    assert not syncs, f"the train step waited for the card at {syncs}"
    return state, losses, walls


def phase_train(cfg):
    """The training main path: full width, full depth, seq 4096."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="none", microbatch=TRAIN_MICROBATCH)
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, plan)
    torch.cuda.synchronize()
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", TRAIN_SEQ,
                                          TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    log(f"[10 train] {cfg.name} full width, {cfg.num_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B params (float32 master, AdamW "
        f"float32 moments, {cfg.dtype} compute), seq {TRAIN_SEQ}, batch "
        f"{TRAIN_BATCH} (train_4k's 256 cut to {TRAIN_BATCH}), microbatch "
        f"{TRAIN_MICROBATCH}, remat {plan.remat}; init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_k1_counters()
    state, losses, walls = _unsynced_steps(step, state, batches)
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    want = cfg.num_layers * TRAIN_STEPS * TRAIN_MICROBATCH
    assert launches == {"flash_attention": want,
                        "flash_attention_bwd": want}, (launches, want)
    paths = _k1_paths(cfg, want)
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    log(f"[10 train] losses={[round(x, 4) for x in losses]} step_wall_s="
        f"{[round(x, 3) for x in walls]} (the first includes set-up) "
        f"steady_step_s={steady:.3f} tok_per_s="
        f"{TRAIN_BATCH * TRAIN_SEQ / steady:.1f} max_memory_allocated_GB="
        f"{peak / 1e9:.2f} launches={launches} (want {want} each) "
        f"paths={paths}; no host-device sync inside steps 2-{TRAIN_STEPS}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[TRAIN_STEPS])
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    split, by_name = _device_split(prof)
    busy = sum(split.values())
    assert busy > 0, "the profiler saw no device time"
    log(f"[10 train profile] one step: wall_ms={wall:.1f} device_busy_ms="
        f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall):.3f} " + " ".join(
            f"{k.replace(' ', '_')}_ms={v:.1f} ({v / busy:.1%})"
            for k, v in split.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[10 train profile]   {ms:9.1f} ms  {name}")
    none = dict(loss=losses[0], steady_s=steady, peak_gb=peak / 1e9)
    return model, state, launches, none


def phase_train_dots(cfg, none: dict) -> dict:
    """The training main path at remat ``dots`` (each block's products
    saved, the rest recomputed in the backward), from the state phase 10
    started from: K1 twice a layer a step (the forward and its
    recompute), K1-bwd once, all on the tensor cores (counters reset just
    before the steps, read just after); the step wall and the peak beside
    remat none's; the first step's loss against none's.  Returns K1's and
    K1-bwd's launches."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="dots", microbatch=TRAIN_MICROBATCH)
    state = init_train_state(model, 0, opt, plan)
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", TRAIN_SEQ,
                                          TRAIN_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_k1_counters()
    state, losses, walls = _unsynced_steps(step, state, batches)
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    want = cfg.num_layers * TRAIN_STEPS * TRAIN_MICROBATCH
    assert launches == {"flash_attention": 2 * want,
                        "flash_attention_bwd": want}, (launches, want)
    assert flash_attention.fma_launches == 0, flash_attention.fma_launches
    assert flash_attention_bwd.fma_launches == 0
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = statistics.median(walls[1:])
    rel = abs(losses[0] - none["loss"]) / abs(none["loss"])
    log(f"[10 train dots] remat dots: losses={[round(x, 4) for x in losses]} "
        f"step_wall_s={[round(x, 3) for x in walls]} steady_step_s="
        f"{steady:.3f} (none {none['steady_s']:.3f}) tok_per_s="
        f"{TRAIN_BATCH * TRAIN_SEQ / steady:.1f} max_memory_allocated_GB="
        f"{peak:.2f} (none {none['peak_gb']:.2f}) launches={launches} (want "
        f"{2 * want} and {want}: K1 {2 * cfg.num_layers} and K1-bwd "
        f"{cfg.num_layers} a step, tensor-cores "
        f"{flash_attention.tc_launches} and {flash_attention_bwd.tc_launches}"
        f"); first step's loss {losses[0]!r} against none's "
        f"{none['loss']!r}: rel {rel:.3g} (bound 1e-6), bit for bit: "
        f"{losses[0] == none['loss']}")
    assert rel <= 1e-6, (losses[0], none["loss"])
    del state, batches, step, model
    torch.cuda.empty_cache()
    return launches


def phase_train_plain(model, state, cfg) -> None:
    """One step's loss and gradient norm at full width, kernel path vs
    plain path (batch 1, seq 1024)."""
    stream = make_stream(cfg, ShapeConfig("t", 1024, 1, "train"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    params = state["params"]

    def loss_and_norm():
        flat = [p.requires_grad_() for p in leaves(params)]
        loss, _ = model.loss(params, batch, remat="none")
        grads = torch.autograd.grad(loss, flat)
        norm = global_norm(dict(enumerate(grads)))
        return float(loss.detach()), float(norm)

    kern = loss_and_norm()
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    with mock.patch.object(ops, "flash_attention", ref.attention):
        plain = loss_and_norm()
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0
    rel_loss = abs(kern[0] - plain[0]) / abs(plain[0])
    rel_norm = abs(kern[1] - plain[1]) / abs(plain[1])
    log(f"[11 train kernel vs plain] loss {kern[0]:.6f} vs {plain[0]:.6f} "
        f"(rel {rel_loss:.3g}, bound {LOSS_REL_BOUND}); grad_norm "
        f"{kern[1]:.6f} vs {plain[1]:.6f} (rel {rel_norm:.3g}, bound "
        f"{GNORM_REL_BOUND})")
    assert rel_loss <= LOSS_REL_BOUND and rel_norm <= GNORM_REL_BOUND


def phase_resume(cfg2, phase: int, note: str, seq: int = 1024,
                 batch: int = 2) -> None:
    """4 steps unbroken against 2 + save/restore + 2, bit for bit."""
    model = build_model(cfg2)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="none")
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg2, ShapeConfig("t", seq, batch, "train"))

    def run(state, steps):
        out = []
        for i in steps:
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in stream.batch_at(i).items()}
            state, metrics = step(state, batch)
            out.append(float(metrics["loss"]))
        return state, out

    torch.use_deterministic_algorithms(True)
    try:
        a, losses_a = run(init_train_state(model, 0, opt, plan), range(4))
        b, losses_b = run(init_train_state(model, 0, opt, plan), range(2))
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            ck = Checkpointer(d, keep=1)
            ck.save(1, b)
            del b
            fresh = init_train_state(model, 1, opt, plan)  # another seed
            b, saved = ck.restore(fresh)
            del fresh
            io_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs)
        b, more = run(b, range(saved + 1, 4))
        losses_b += more
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(x, y) for (_, x), (_, y)
               in zip(flatten(a), flatten(b)))
    log(f"[{phase} resume] {cfg2.name} seq {seq} batch {batch} ({note}): "
        f"unbroken {losses_a} resumed {losses_b}; checkpoint "
        f"{nbytes / 1e9:.2f} GB saved and restored in {io_s:.1f} s; "
        f"losses identical={losses_a == losses_b} state identical={same}")
    assert losses_a == losses_b and same, "resume is not exact"


# ---------------------------------------------------------------------------
def _abs_rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|), the abs+rel measure of ``TOL``."""
    want = want.double()
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


def _grad_err(got, want, tol: float) -> float:
    """max |got - want| over max |want|, asserted within ``tol``."""
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= tol, f"gradient off by {err:.3g} of its max (tol {tol})"
    return err


def _mlstm_inputs(gen, dtype, B, H, S, D, DV, with_dh=False):
    """q, k, v and the gate pre-activations of an mLSTM on the card
    (and, with ``with_dh``, an incoming gradient dh drawn after v)."""
    dev = torch.device("cuda")
    q, k = (torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    v = torch.randn((B, H, S, DV), generator=gen, device=dev).to(dtype)
    dh = (torch.randn((B, H, S, DV), generator=gen, device=dev).to(dtype)
          if with_dh else None)
    i_pre = torch.randn((B, H, S), generator=gen, device=dev).to(dtype)
    f_pre = (torch.randn((B, H, S), generator=gen, device=dev) + 1).to(dtype)
    return (q, k, v, i_pre, f_pre), dh


def _k6_case(name, dtype, B, H, S, D, DV, gen):
    chunk = mlstm_scan.kernel_chunk(dtype, D, DV)  # the plain versions' too
    xs, dh = _mlstm_inputs(gen, dtype, B, H, S, D, DV, with_dh=True)
    q, k, v, i_pre, f_pre = xs
    tc0 = (mlstm_scan.tc_launches, mlstm_scan.bwd_tc_launches)
    h, m, qn = mlstm_scan.mlstm_scan_cuda(*xs, with_stats=True)
    path = _path(mlstm_scan.tc_launches - tc0[0])
    want = ref.mlstm_scan_chunked(*xs, with_stats=True, chunk=chunk)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        # float32 against float64: the plain version on the same inputs in
        # float64 is the oracle.  Two float32 summation orders, each within
        # e of the exact result, may differ by 2 e, and the kernel's chunk
        # reduction order adds another factor of 2: the kernel is held to 4
        # times the float32 plain version's own error, and never less than
        # the float32 TOL
        x64 = tuple(x.double() for x in xs)
        want64 = ref.mlstm_scan_chunked(*x64, with_stats=True, chunk=chunk)
        plain_fwd = max(_abs_rel_err(w, o) for w, o in zip(want, want64))
        fwd_bound = max(TOL[dtype], 4 * plain_fwd)
        err_fwd = max(max_err(g, o, dtype, fwd_bound)
                      for g, o in zip((h, m, qn), want64))
        kern_fwd = max(_abs_rel_err(g, o) for g, o in zip((h, m, qn), want64))
        vs_plain = max(_abs_rel_err(g, w) for g, w in zip((h, m, qn), want))
        fwd_note = (f"against float64: {kern_fwd:.3g} abs+rel (bound "
                    f"{fwd_bound:.3g} = max({TOL[dtype]:g}, 4 x the float32 "
                    f"plain version's {plain_fwd:.3g}), h, m, qn); kernel vs "
                    f"float32 plain {vs_plain:.3g}")
    else:
        err_fwd = max(max_err(h, want[0], dtype),
                      max_err(m, want[1], dtype, TOL[torch.float32]),
                      max_err(qn, want[2], dtype))
        fwd_note = f"(tol {TOL[dtype]:g} abs+rel, h, m, qn)"
    again = mlstm_scan.mlstm_scan_cuda(*xs, with_stats=True)
    got = mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn, dh)
    bwd_path = _path(mlstm_scan.bwd_tc_launches - tc0[1])
    if dtype == torch.float32:
        want64 = ref.mlstm_scan_bwd(*x64, *want64, dh.double(), chunk=chunk)
        plain = ref.mlstm_scan_bwd(*xs, *want, dh, chunk=chunk)
        plain_bwd = max(_grad_err(w, o, float("inf"))
                        for w, o in zip(plain, want64))
        bwd_bound = max(MLSTM_GRAD_TOL[dtype], 4 * plain_bwd)
        err = max(_grad_err(g, o, bwd_bound) for g, o in zip(got, want64))
        del plain, want
        want = ref.mlstm_scan_bwd(*xs, h, m, qn, dh, chunk=chunk)
        vs_plain = max(_grad_err(g, w, float("inf"))
                       for g, w in zip(got, want))
        bwd_note = (f"against float64: {err:.3g} (bound {bwd_bound:.3g} = "
                    f"max({MLSTM_GRAD_TOL[dtype]:g}, 4 x the float32 plain "
                    f"version's {plain_bwd:.3g}) of each gradient's max, dq dk "
                    f"dv di df); kernel vs float32 plain {vs_plain:.3g}")
        del want64, x64
    else:
        del want
        want = ref.mlstm_scan_bwd(*xs, h, m, qn, dh, chunk=chunk)
        err = max(_grad_err(g, w, MLSTM_GRAD_TOL[dtype])
                  for g, w in zip(got, want))
        bwd_note = (f"(tol {MLSTM_GRAD_TOL[dtype]:g} of each gradient's max, "
                    f"dq dk dv di df)")
    torch.cuda.synchronize()
    del want
    assert all(torch.equal(a, b) for a, b in zip((h, m, qn), again)), \
        "K6 is not deterministic"
    again = mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn, dh)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K6-bwd is not deterministic"
    del again, got
    ms = time_ms(lambda: mlstm_scan.mlstm_scan_cuda(*xs, with_stats=True),
                 reps=5, inner=3)
    bwd_ms = time_ms(lambda: mlstm_scan.mlstm_scan_bwd_cuda(*xs, h, m, qn,
                                                            dh),
                     reps=5, inner=3)
    plain_ms = time_ms(lambda: ref.mlstm_scan_chunked(*xs, with_stats=True,
                                                      chunk=chunk),
                       reps=3, inner=1)
    plain_bwd_ms = time_ms(lambda: ref.mlstm_scan_bwd(*xs, h, m, qn, dh,
                                                      chunk=chunk),
                           reps=3, inner=1)
    # bounds: each input read once, each output written once; the
    # products of chunks of K6_BOUND_CHUNK rows, per row: K6 2 L (D + DV)
    # (scores and their product with v) + 4 D DV (q C and the state
    # update); K6-bwd 2 L (3 D + 2 DV) (S, dS and the three intra-chunk
    # products) + 10 D DV (the state recomputed, q's and k's inter-chunk
    # products, dC and v's inter-chunk product)
    L, rows = K6_BOUND_CHUNK, B * H * S
    size = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    fbytes = rows * (size * (2 * D + 2 * DV) + 2 * size + 8)
    bms, by = bound_ms(fbytes, rows * (2.0 * L * (D + DV) + 4.0 * D * DV),
                       peak)
    bbytes = rows * (size * (4 * D + 4 * DV) + 4 * size + 8)
    bbms, bby = bound_ms(bbytes, rows * (2.0 * L * (3 * D + 2 * DV)
                                         + 10.0 * D * DV), peak)
    shape = f"B={B} H={H} S={S} D={D} DV={DV}"
    log(f"[13 K6] {name} {str(dtype)[6:]} {shape} path={path} chunk={chunk}: "
        f"max_abs_err={err_fwd:.3g} {fwd_note} deterministic=True "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
        f"bound_ms={bms:.5f} ({by})")
    log(f"[13 K6-bwd] {name} {str(dtype)[6:]} {shape} path={bwd_path}: "
        f"max_err_of_max="
        f"{err:.3g} {bwd_note} deterministic=True ms={bwd_ms:.4f} plain_ms="
        f"{plain_bwd_ms:.4f} library_ms=None bound_ms={bbms:.5f} ({bby})")
    return (dict(max_abs_err=err_fwd, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, library_ms=None),
            dict(max_abs_err=err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                 bound_ms=bbms, bound_by=bby, library_ms=None))


def phase_k6(gen, cfg):
    """K6 and K6-bwd at the training shape (bf16), S = 1000 and D = 64
    (both dtypes)."""
    H, D = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
    main = _k6_case("train-shape", torch.bfloat16, XL_BATCH, H, XL_SEQ, D, D,
                    gen)
    torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        _k6_case("S=1000", dtype, 1, H, 1000, D, D, gen)
        _k6_case("D=64", dtype, 2, H, 4096, 64, 64, gen)
        torch.cuda.empty_cache()
    return main


_SLSTM_LOOP = recurrent.slstm_loop
# K6's and K6-bwd's kernels by name, both paths: the tensor cores'
# (mlstm_fwd_tc_kernel; mlstm_dv_tc_kernel, mlstm_dq_tc_kernel,
# mlstm_dk_tc_kernel) and the FMAs' (mlstm_fwd_kernel; mlstm_dv_kernel,
# mlstm_dqdk_kernel), and the backward's prologue and gate epilogue, which
# both paths run
K6_KERNELS = ("mlstm_fwd_kernel", "mlstm_fwd_tc_kernel")
K6_BWD_KERNELS = ("mlstm_prep_kernel", "mlstm_dv_kernel", "mlstm_dqdk_kernel",
                  "mlstm_dv_tc_kernel", "mlstm_dq_tc_kernel",
                  "mlstm_dk_tc_kernel", "mlstm_gates_kernel")


def _mark(grad=None):
    """A marker kernel (``spin_kernel``) on the stream; as a gradient hook
    it leaves the gradient as it is."""
    torch.cuda._sleep(1)


def _marked_slstm_loop(wx, r, state):
    """The sLSTM loop between marker kernels: one before and one after
    its forward, one when its output's gradient arrives (its backward
    begins) and one when wx's gradient is whole (its backward is done)."""
    _mark()
    if wx.requires_grad:
        wx.register_hook(_mark)
    hs, state = _SLSTM_LOOP(wx, r, state)
    _mark()
    if hs.requires_grad:
        hs.register_hook(_mark)
    return hs, state


def _xlstm_split(prof, n_slstm: int):
    """Device ms of one profiled step by kind (K6, K6-bwd, the kernels
    between the sLSTM loop's markers, GEMMs, rest), the kernel count, and
    device ms by kernel name (cut to 60 characters)."""
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    split = {"K6": 0.0, "K6-bwd": 0.0, "sLSTM loop": 0.0, "GEMMs": 0.0,
             "rest": 0.0}
    by_name, inside, markers, loop_kernels = {}, False, 0, 0
    for e in events:
        name = e.name()
        ms = e.duration_ns() / 1e6
        if "spin_kernel" in name:
            inside, markers = not inside, markers + 1
            continue
        low = name.lower()
        if any(k in name for k in K6_KERNELS):
            kind = "K6"
        elif any(k in name for k in K6_BWD_KERNELS):
            kind = "K6-bwd"
        elif inside:
            kind = "sLSTM loop"
            loop_kernels += 1
        elif any(k in low for k in GEMM_KERNELS):
            kind = "GEMMs"
        else:
            kind = "rest"
        split[kind] += ms
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
    assert markers == 4 * n_slstm, (markers, n_slstm)
    return split, len(events) - markers, loop_kernels, by_name


def phase_xlstm_train(cfg):
    """The xLSTM training main path: full width, full depth, seq 4096."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="none", microbatch=XL_MICROBATCH)
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, plan)
    torch.cuda.synchronize()
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", XL_SEQ, XL_BATCH,
                                          "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(XL_STEPS + 1)]
    n_s = cfg.num_layers // cfg.slstm_every if cfg.slstm_every else 0
    n_m = cfg.num_layers - n_s
    log(f"[14 xlstm train] {cfg.name} full width, {cfg.num_layers} layers "
        f"({n_m} mLSTM, {n_s} sLSTM), d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, {cfg.param_count() / 1e9:.4f} B params "
        f"(float32 master, AdamW float32 moments, {cfg.dtype} compute), seq "
        f"{XL_SEQ}, batch {XL_BATCH} (train_4k's 256 cut to {XL_BATCH}), "
        f"microbatch {XL_MICROBATCH}, remat {plan.remat}; init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    for counter in ("launches", "bwd_launches", "tc_launches",
                    "bwd_tc_launches"):
        setattr(mlstm_scan, counter, 0)
    losses, walls = [], []
    for i in range(XL_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
    launches = {"mlstm_scan": mlstm_scan.launches,
                "mlstm_scan_bwd": mlstm_scan.bwd_launches}
    tc_launches = {"mlstm_scan": mlstm_scan.tc_launches,
                   "mlstm_scan_bwd": mlstm_scan.bwd_tc_launches}
    want = n_m * XL_STEPS * XL_MICROBATCH
    assert launches == {"mlstm_scan": want, "mlstm_scan_bwd": want}, \
        (launches, want)
    # every bf16 launch at xlstm-125m's head width (384) on the tensor cores
    assert tc_launches == launches, (tc_launches, launches)
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    log(f"[14 xlstm train] losses={[round(x, 4) for x in losses]} "
        f"step_wall_s={[round(x, 3) for x in walls]} (the first includes "
        f"set-up) steady_step_s={steady:.3f} tok_per_s="
        f"{XL_BATCH * XL_SEQ / steady:.1f} max_memory_allocated_GB="
        f"{peak / 1e9:.2f} launches={launches} (want {want} each; on the "
        f"tensor cores {tc_launches})")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(recurrent, "slstm_loop", _marked_slstm_loop), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[XL_STEPS])
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    split, n_kernels, loop_kernels, by_name = _xlstm_split(prof, n_s)
    parse_s = time.perf_counter() - t0
    del prof
    busy = sum(split.values())
    assert busy > 0 and split["K6"] > 0 and split["K6-bwd"] > 0, split
    log(f"[14 xlstm profile] one step: wall_ms={wall:.1f} device_busy_ms="
        f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall):.3f} "
        f"(against the unprofiled steady step: "
        f"{max(0.0, 1 - busy / (steady * 1e3)):.3f}) kernels={n_kernels} "
        f"(sLSTM loop {loop_kernels}) " + " ".join(
            f"{k.replace(' ', '_')}_ms={v:.1f} ({v / busy:.1%})"
            for k, v in split.items()) + f" (parsed in {parse_s:.1f} s)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[14 xlstm profile]   {ms:9.1f} ms  {name}")
    return model, state, launches


def _plain_mlstm(q, k, v, i_pre, f_pre, chunk=256):
    """``ops.mlstm_scan`` through K6's plain version, under autograd."""
    return ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre)


def _ulp_moved_mlstm(gen):
    """The plain path with a tenth of h's bf16 entries moved by one ulp
    (in the forward only): how far bf16 rounding alone moves the step."""
    def fn(q, k, v, i_pre, f_pre, chunk=256):
        h = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre)
        bits = h.detach().view(torch.int16)
        flip = ((torch.rand(h.shape, generator=gen, device=h.device) < 0.1)
                & (h != 0))  # a zero's bits minus one would be a NaN
        up = torch.rand(h.shape, generator=gen, device=h.device) < 0.5
        step = flip.to(torch.int16) * (2 * up.to(torch.int16) - 1)
        return h + ((bits + step).view(torch.bfloat16) - h).detach()
    return fn


def phase_xlstm_plain(cfg, state) -> None:
    """One xLSTM step's loss and gradient norm at full width, kernel path
    vs plain path (batch 1, seq 1024), on the trained parameters.  The
    bounds hold in float32 compute.  In bf16 the gradient norm is
    dominated by rounding: the comparison is logged beside the plain
    path with h moved by one bf16 ulp, which shows that spread."""
    stream = make_stream(cfg, ShapeConfig("t", 1024, 1, "train"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    params = state["params"]

    def loss_and_norm(model, fn=None):
        flat = [p.requires_grad_() for p in leaves(params)]
        with mock.patch.object(ops, "mlstm_scan", fn or ops.mlstm_scan):
            loss, _ = model.loss(params, batch, remat="none")
        grads = torch.autograd.grad(loss, flat)
        norm = global_norm(dict(enumerate(grads)))
        return float(loss.detach()), float(norm)

    def compare(model):
        kern = loss_and_norm(model)
        n0 = (mlstm_scan.launches, mlstm_scan.bwd_launches)
        plain = loss_and_norm(model, _plain_mlstm)
        assert (mlstm_scan.launches, mlstm_scan.bwd_launches) == n0
        return (kern, plain, abs(kern[0] - plain[0]) / abs(plain[0]),
                abs(kern[1] - plain[1]) / abs(plain[1]))

    kern, plain, rel_loss, rel_norm = compare(
        build_model(dataclasses.replace(cfg, dtype="float32")))
    log(f"[15 xlstm kernel vs plain] float32 compute: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {rel_loss:.3g}, bound {LOSS_REL_BOUND}); "
        f"grad_norm {kern[1]:.6f} vs {plain[1]:.6f} (rel {rel_norm:.3g}, "
        f"bound {GNORM_REL_BOUND})")
    assert rel_loss <= LOSS_REL_BOUND and rel_norm <= GNORM_REL_BOUND
    model = build_model(cfg)
    kern, plain, rel_loss, rel_norm = compare(model)
    gen = torch.Generator(device="cuda")
    moved = []
    for seed in range(2):
        gen.manual_seed(seed)
        moved.append(loss_and_norm(model, _ulp_moved_mlstm(gen))[1])
    log(f"[15 xlstm kernel vs plain] {cfg.dtype} compute (not bounded): loss "
        f"rel {rel_loss:.3g}; grad_norm {kern[1]:.5f} vs {plain[1]:.5f} (rel "
        f"{rel_norm:.3g}); the plain path with a tenth of h moved by one "
        f"ulp: grad_norm {[round(x, 5) for x in moved]}")


# ---------------------------------------------------------------------------
def ssm_bound_ms(nbytes: float, flops: float, exps: float):
    """The least time for a scan: the larger of its bytes over the memory
    rate, its float32 operations over the float32 peak, and its
    exponentials over the special-function units' rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / F32_FLOPS, exps / SFU_EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _ssm_fwd_ckpt64(x, dt, A, Bmat, Cmat, D):
    """K5's plain version, ``ref.ssm_scan_fwd_ckpt``'s chunk walk, run in
    float64: ``(y, ckpt, the final state)``."""
    S, chunk = x.shape[1], ref.SSM_CHUNK
    xf, dtf, bf, cf = (F.pad(t.double(), (0, 0, 0, -S % chunk))
                       for t in (x, dt, Bmat, Cmat))
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]),
                    dtype=torch.float64, device=x.device)
    ys, ckpts = [], []
    for t0 in range(0, xf.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        ckpts.append(h)
        _, hs = ref._ssm_chunk_states(h, xf[:, sl], dtf[:, sl], bf[:, sl],
                                      A.double())
        ys.append((hs[:, 1:] * cf[:, sl, None, :]).sum(-1))
        h = hs[:, -1]
    return (torch.cat(ys, 1)[:, :S] + x.double() * D.double(),
            torch.stack(ckpts), h)


def _ssm_inputs(gen, dtype, B, S, Din, N):
    """x, dt (softplus-sized steps), A, B, C and D of a scan on the card."""
    dev = torch.device("cuda")
    x = torch.randn((B, S, Din), generator=gen, device=dev).to(dtype)
    dt = (torch.rand((B, S, Din), generator=gen, device=dev) * 0.2
          + 0.01).to(dtype)
    A = -torch.rand((Din, N), generator=gen, device=dev) * 2 - 0.05
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device=dev)
              for _ in range(2))
    D = torch.randn((Din,), generator=gen, device=dev)
    return x, dt, A, Bm, Cm, D


def _k5_case(name, dtype, B, S, Din, N, gen, phase=17):
    xs = _ssm_inputs(gen, dtype, B, S, Din, N)
    dy = torch.randn((B, S, Din), generator=gen, device="cuda").to(dtype)
    y, ckpt = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
    want = ref.ssm_scan_fwd_ckpt(*xs)
    torch.cuda.synchronize()
    # The float32 states (and, in float32, y) against the plain version run
    # in float64, as phase 13 holds K6: the scan's order and the sequential
    # order differ by more than 2e-5 abs+rel in float32 at a few of the
    # training shape's outputs (and under weak decay at many); the kernel is
    # held to 4 times the float32 plain version's own error there, never
    # less than 2e-5.  bf16 y against the float32 plain version at 2e-2.
    exact = _ssm_fwd_ckpt64(*xs)
    pairs = [(ckpt, want[1], exact[1])]
    if dtype == torch.float32:
        pairs.append((y, want[0], exact[0]))
    plain_fwd = max(_abs_rel_err(w, e) for _, w, e in pairs)
    fwd_bound = max(TOL[torch.float32], 4 * plain_fwd)
    err_fwd = max(max_err(g, e, dtype, fwd_bound) for g, _, e in pairs)
    kern_fwd = max(_abs_rel_err(g, e) for g, _, e in pairs)
    if dtype == torch.bfloat16:
        err_fwd = max(err_fwd, max_err(y, want[0], dtype))
    fwd_note = (f"states{' and y' if dtype == torch.float32 else ''} "
                f"against float64: {kern_fwd:.3g} abs+rel (bound "
                f"{fwd_bound:.3g} = max(2e-05, 4 x the float32 plain "
                f"version's {plain_fwd:.3g})"
                + (f"; y tol {TOL[dtype]:g} abs+rel against the plain version"
                   if dtype == torch.bfloat16 else "") + ")")
    del want, exact, pairs
    again = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
    got = ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy)
    want = ref.ssm_scan_bwd(*xs, ckpt, dy)
    torch.cuda.synchronize()
    err = max(_grad_err(g, w, SSM_GRAD_TOL[dtype]) for g, w in zip(got, want))
    del want
    assert all(torch.equal(a, b) for a, b in zip((y, ckpt), again)), \
        "K5 is not deterministic"
    again = ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "K5-bwd is not deterministic"
    del again, got
    ms = time_ms(lambda: ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True), reps=5,
                 inner=5)
    bwd_ms = time_ms(lambda: ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy),
                     reps=5, inner=5)
    # the plain pair is a loop of small launches a step: timed between
    # events, not captured
    plain_ms = time_events_ms(lambda: ref.ssm_scan_fwd_ckpt(*xs), reps=2)
    plain_bwd_ms = time_events_ms(lambda: ref.ssm_scan_bwd(*xs, ckpt, dy),
                                  reps=2)
    # bounds: each input read once, each output written once (K5 writes y
    # and the chunk-start states, K5-bwd reads them); per (b, t, channel,
    # n) one exponential, and 7 float32 operations forward (the decay's
    # argument, the state update's three, the input's two, y's product and
    # sum), 22 backward (the states recomputed, then the adjoint)
    elems = B * S * Din * N
    size = torch.finfo(dtype).bits // 8
    small = 4 * (Din * N + Din)  # A and D (and their gradients)
    ck_bytes = 4 * ckpt.numel()
    fbytes = size * 3 * B * S * Din + 4 * 2 * B * S * N + small + ck_bytes
    bms, by = ssm_bound_ms(fbytes, 7.0 * elems, elems)
    bbytes = (size * 5 * B * S * Din + 4 * 4 * B * S * N + 2 * small
              + ck_bytes)
    bbms, bby = ssm_bound_ms(bbytes, 22.0 * elems, elems)
    shape = f"B={B} S={S} Din={Din} N={N}"
    log(f"[{phase} K5] {name} {str(dtype)[6:]} {shape}: "
        f"max_abs_err={err_fwd:.3g} "
        f"({fwd_note} deterministic=True "
        f"ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms=None "
        f"bound_ms={bms:.5f} ({by}: {fbytes / 1e6:.1f} MB, {elems / 1e6:.1f} M "
        f"exponentials at {SFU_EXP_PER_S / 1e12:.2f} T/s, {7 * elems / 1e9:.2f} "
        f"GFLOP float32)")
    log(f"[{phase} K5-bwd] {name} {str(dtype)[6:]} {shape}: max_err_of_max="
        f"{err:.3g} (tol {SSM_GRAD_TOL[dtype]:g} of each gradient's max, dx "
        f"ddt dA dB dC dD) deterministic=True ms={bwd_ms:.4f} plain_ms="
        f"{plain_bwd_ms:.3f} library_ms=None bound_ms={bbms:.5f} ({bby}: "
        f"{bbytes / 1e6:.1f} MB, {elems / 1e6:.1f} M exponentials, "
        f"{22 * elems / 1e9:.2f} GFLOP float32)")
    return (dict(max_abs_err=err_fwd, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, library_ms=None),
            dict(max_abs_err=err, ms=bwd_ms, plain_ms=plain_bwd_ms,
                 bound_ms=bbms, bound_by=bby, library_ms=None))


def phase_k5(gen, cfg):
    """K5 and K5-bwd at hymba's training shape (the main path's batch, and
    batch 1) and at a ragged S and Din (both dtypes)."""
    d_in, N = recurrent.ssm_dims(cfg)[:2]
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        r = _k5_case("train-shape", dtype, HY_BATCH, HY_SEQ, d_in, N, gen)
        main = main or r
        if dtype == torch.bfloat16:
            _k5_case("batch-1", dtype, 1, HY_SEQ, d_in, N, gen)
        _k5_case("ragged", dtype, 2, 1000, 1000, N, gen)
        torch.cuda.empty_cache()
    return main


def phase_k1_hymba(gen, cfg) -> None:
    """K1 with its LSE and K1-bwd at hymba's attention shapes: global and
    with its 2048 window in a 4096 sequence."""
    for dtype in (torch.bfloat16, torch.float32):
        for window in (0, cfg.sliding_window):
            _k1_train_case(f"hymba window={window}", dtype, 1, HY_SEQ,
                           HY_SEQ, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, window, 0, gen, phase=18)
            torch.cuda.empty_cache()


HYMBA_KINDS = dict(K1_KINDS, **{
    "K5": ("ssm_scan_fwd_kernel",),
    "K5-bwd": ("ssm_scan_bwd_kernel", "ssm_bwd_sums_kernel")})


def phase_hymba_train(cfg):
    """The hybrid training main path: full width, full depth, seq 4096."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="none")
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, plan)
    torch.cuda.synchronize()
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", HY_SEQ, HY_BATCH,
                                          "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(HY_STEPS + 1)]
    n_global = len(cfg.global_attn_layers)
    log(f"[19 hymba train] {cfg.name} full width, {cfg.num_layers} layers "
        f"({n_global} global, {cfg.num_layers - n_global} with a "
        f"{cfg.sliding_window} window), d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, SSM "
        f"d_inner {recurrent.ssm_dims(cfg)[0]} state {cfg.ssm_state}, "
        f"{cfg.param_count() / 1e9:.3f} B params (float32 master, AdamW "
        f"float32 moments, {cfg.dtype} compute), seq {HY_SEQ}, batch "
        f"{HY_BATCH} (train_4k's 256 cut to {HY_BATCH}), remat "
        f"{plan.remat}; init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    counters = {"ssm_scan": (ssm_scan, "launches"),
                "ssm_scan_bwd": (ssm_scan, "bwd_launches"),
                "flash_attention": (flash_attention, "launches"),
                "flash_attention_bwd": (flash_attention_bwd, "launches")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    _reset_k1_counters()
    losses, walls = [], []
    for i in range(HY_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    want = cfg.num_layers * HY_STEPS
    assert launches == dict.fromkeys(counters, want), (launches, want)
    paths = _k1_paths(cfg, want)
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    log(f"[19 hymba train] losses={[round(x, 4) for x in losses]} "
        f"step_wall_s={[round(x, 3) for x in walls]} (the first includes "
        f"set-up) steady_step_s={steady:.3f} tok_per_s="
        f"{HY_BATCH * HY_SEQ / steady:.1f} max_memory_allocated_GB="
        f"{peak / 1e9:.2f} launches={launches} (want {want} each) "
        f"paths={paths}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[HY_STEPS])
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    split, by_name = _device_split(prof, HYMBA_KINDS)
    del prof
    busy = sum(split.values())
    assert busy > 0 and split["K5"] > 0 and split["K5-bwd"] > 0, split
    log(f"[19 hymba profile] one step: wall_ms={wall:.1f} device_busy_ms="
        f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall):.3f} (against the "
        f"unprofiled steady step: {max(0.0, 1 - busy / (steady * 1e3)):.3f}) "
        + " ".join(f"{k.replace(' ', '_')}_ms={v:.1f} ({v / busy:.1%})"
                   for k, v in split.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[19 hymba profile]   {ms:9.1f} ms  {name}")
    return launches


def _plain_ssm(x, dt, A, Bmat, Cmat, D, **_):
    """``ops.ssm_scan`` through autodiff of the sequential oracle."""
    return ref.ssm_scan(x, dt, A, Bmat, Cmat, D)[0]


def phase_hymba_plain(cfg2) -> None:
    """One step's loss, gradient norm and every gradient leaf at full
    width (the 2-layer cut), seq 4096, kernel path vs plain path, in
    float32 compute, with the SSM parameters moved off their init."""
    cfg2 = dataclasses.replace(cfg2, dtype="float32")
    model = build_model(cfg2)
    params = model.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    blocks = params["blocks"]
    for name, mean, std in HY_MOVED:
        blocks[name] = mean + std * torch.randn(
            blocks[name].shape, generator=gen, device="cuda")
    stream = make_stream(cfg2, ShapeConfig("t", HY_SEQ, 1, "train"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    names = [k for k, _ in flatten(params)]

    def loss_and_grads():
        flat = [p.requires_grad_() for p in leaves(params)]
        loss, _ = model.loss(params, batch, remat="none")
        grads = torch.autograd.grad(loss, flat)
        return float(loss.detach()), grads

    t0 = time.perf_counter()
    kern, kgrads = loss_and_grads()
    t1 = time.perf_counter()
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches, flash_attention.launches,
          flash_attention_bwd.launches)
    with mock.patch.object(ops, "ssm_scan", _plain_ssm), \
            mock.patch.object(ops, "flash_attention", ref.attention):
        plain, pgrads = loss_and_grads()
    t2 = time.perf_counter()
    assert (ssm_scan.launches, ssm_scan.bwd_launches,
            flash_attention.launches, flash_attention_bwd.launches) == n0
    knorm = float(global_norm(dict(enumerate(kgrads))))
    pnorm = float(global_norm(dict(enumerate(pgrads))))
    rel_loss = abs(kern - plain) / abs(plain)
    rel_norm = abs(knorm - pnorm) / abs(pnorm)
    leaf_err = {n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(names, kgrads, pgrads)}
    worst = max(leaf_err, key=leaf_err.get)
    ssm_worst = max(v for k, v in leaf_err.items() if "/ssm_" in k)
    log(f"[20 hymba kernel vs plain] {cfg2.name} float32 compute, seq "
        f"{HY_SEQ}: loss {kern:.6f} vs {plain:.6f} (rel {rel_loss:.3g}, "
        f"bound {LOSS_REL_BOUND}); grad_norm {knorm:.6f} vs {pnorm:.6f} "
        f"(rel {rel_norm:.3g}, bound {GNORM_REL_BOUND}); worst gradient "
        f"leaf {worst} {leaf_err[worst]:.3g} of its max (SSM leaves "
        f"{ssm_worst:.3g}, bound {HY_LEAF_BOUND}); {t1 - t0:.1f} s vs "
        f"{t2 - t1:.1f} s")
    assert rel_loss <= LOSS_REL_BOUND and rel_norm <= GNORM_REL_BOUND
    assert leaf_err[worst] <= HY_LEAF_BOUND, leaf_err


# ---------------------------------------------------------------------------
def _gmm_bound(dtype, M_live, M, K, N, E):
    """K4's bound: x read, w read, out written once; 2 K N flops a live
    row (the rows past sum(sizes) are only written)."""
    size = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return bound_ms(size * (M * K + E * K * N + M * N) + 4 * E,
                    2.0 * M_live * K * N, peak)


def _gmm_err(got, want, dtype) -> float:
    got, want = got.detach(), want.detach()
    if dtype == torch.bfloat16:
        return max_err(got, want, dtype, GMM_TOL[dtype])
    return _grad_err(got, want, GMM_TOL[dtype])


def _k4_case(name, dtype, M, K, N, sizes, gen, transpose_w=False,
             timed=True, tag="22 K4"):
    dev = torch.device("cuda")
    E = len(sizes)
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    wshape = (E, N, K) if transpose_w else (E, K, N)
    w = (torch.randn(wshape, generator=gen, device=dev) * K ** -0.5
         ).to(dtype)
    s = torch.tensor(sizes, dtype=torch.int32).to(dev)
    n_tc = moe_gmm.tc_launches
    got = moe_gmm.moe_gmm_cuda(x, s, w, transpose_w=transpose_w)
    path = _path(moe_gmm.tc_launches - n_tc)
    want = moe_gmm.plain(x, sizes, w, transpose_w=transpose_w)
    torch.cuda.synchronize()
    n = min(sum(sizes), M)
    err = _gmm_err(got[:n], want[:n], dtype)
    del want
    assert torch.count_nonzero(got[n:]) == 0, "rows past sum(sizes) not 0"
    again = moe_gmm.moe_gmm_cuda(x, s, w, transpose_w=transpose_w)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "K4 is not deterministic"
    del again
    bms, by = _gmm_bound(dtype, n, M, K, N, E)
    r = dict(max_abs_err=err, bound_ms=bms, bound_by=by, ms=None,
             plain_ms=None, library_ms=None)
    if timed:
        slow = dtype == torch.float32 and M * K * N > 1e11
        r["ms"] = time_ms(lambda: moe_gmm.moe_gmm_cuda(
            x, s, w, transpose_w=transpose_w),
            reps=3 if slow else 10, inner=2 if slow else 5)
        r["plain_ms"] = time_events_ms(lambda: moe_gmm.plain(
            x, sizes, w, transpose_w=transpose_w), reps=3)
        if len(set(sizes)) == 1 and sizes[0] * E == M:
            # the library yardstick: one cuBLAS batched GEMM on the
            # equal-group layout (never called by the port's forward)
            xb = x.view(E, M // E, K)
            wb = w.transpose(1, 2) if transpose_w else w
            r["library_ms"] = time_ms(lambda: torch.bmm(xb, wb),
                                      reps=3 if slow else 10,
                                      inner=2 if slow else 5)
    fmt = (lambda v: "null" if v is None else f"{v:.4f}")
    how = "abs+rel" if dtype == torch.bfloat16 else "of max |y|"
    log(f"[{tag}] {name} {str(dtype)[6:]} M={M} K={K} N={N} E={E} "
        f"live_rows={n} transposed_w={transpose_w} path={path}: "
        f"max_abs_err={err:.3g} ({how} tol {GMM_TOL[dtype]:g}) "
        f"rows_past_sum_zero=True deterministic=True "
        f"ms={fmt(r['ms'])} plain_ms={fmt(r['plain_ms'])} library_ms="
        f"{fmt(r['library_ms'])} bound_ms={bms:.5f} ({by})"
        + (f" achieved_TFLOP/s={2.0 * n * K * N / r['ms'] / 1e9:.1f}"
           if r["ms"] else ""))
    return r


def phase_k4(gen, cfg, qcfg) -> dict:
    """K4 against its plain version; the phi3.5-moe forward product of
    the gate projection at batch 2 is the kernel line's entry."""
    rng = np.random.default_rng(2)
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        sizes = rng.multinomial(3000, np.ones(8) / 8).tolist()
        sizes[2] = sizes[5] = 0
        _k4_case("ragged-empty", dtype, sum(sizes), 1024, 1536, sizes, gen)
        _k4_case("rows-past-sum", dtype, 2048, 512, 768,
                 [0, 700, 0, 801, 9], gen, timed=False)
        _k4_case("transposed-w ragged", dtype, 2048, 768, 512,
                 [600, 0, 1000, 448], gen, transpose_w=True, timed=False)
        _k4_case("unaligned widths", dtype, 999, 1000, 900,
                 [300, 0, 333, 366], gen, timed=False)
        # K off the 64-deep stage, N off the 256-wide tile, a ragged tile
        # whose x box reaches into the next group's rows
        _k4_case("K 1000, N 904", dtype, 1500, 1000, 904,
                 [200, 700, 0, 550], gen, timed=False)
        torch.cuda.empty_cache()
    # phi3.5-moe at batch 2: 16 groups of B C = 2 x 640 rows
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    G = MOE_BATCH * moe.moe_capacity(cfg, MOE_SEQ)
    for dtype in (torch.bfloat16, torch.float32):
        for name, K, N, tr in (("phi3.5 gate/up", D, F_, False),
                               ("phi3.5 down", F_, D, False),
                               ("phi3.5 gate/up dX", F_, D, True),
                               ("phi3.5 down dX", D, F_, True)):
            timed = dtype == torch.bfloat16 or name == "phi3.5 gate/up"
            r = _k4_case(name, dtype, E * G, K, N, [G] * E, gen,
                         transpose_w=tr, timed=timed)
            if main is None:
                main = r
            torch.cuda.empty_cache()
    # qwen3-moe at batch 2: 128 groups of 2 x 320 rows
    E, D, F_ = qcfg.num_experts, qcfg.d_model, qcfg.d_ff
    G = MOE_BATCH * moe.moe_capacity(qcfg, MOE_SEQ)
    for name, K, N, tr in (("qwen3 gate/up", D, F_, False),
                           ("qwen3 down", F_, D, False),
                           ("qwen3 gate/up dX", F_, D, True)):
        _k4_case(name, torch.bfloat16, E * G, K, N, [G] * E, gen,
                 transpose_w=tr)
        torch.cuda.empty_cache()
    return main


def phase_moe_gmm_bwd(gen, cfg) -> None:
    """``MoeGmm``'s forward and backward at phi3.5-moe's gate projection
    (batch 2) in bf16, and at a ragged cut in float32, against autograd of
    the plain version; a rerun gives the same bits."""
    dev = torch.device("cuda")
    G = MOE_BATCH * moe.moe_capacity(cfg, MOE_SEQ)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    for dtype, sizes, K, N in ((torch.bfloat16, [G] * E, D, F_),
                               (torch.float32, [700, 0, 1100, 248], 1024,
                                1536)):
        M = sum(sizes)
        x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        w = (torch.randn((len(sizes), K, N), generator=gen, device=dev)
             * K ** -0.5).to(dtype)
        dy = torch.randn((M, N), generator=gen, device=dev).to(dtype)
        runs = []
        n0 = moe_gmm.launches
        for _ in range(2):
            tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = ops.moe_gmm(tx, sizes, tw)
            runs.append((y,) + torch.autograd.grad(y, (tx, tw), dy))
            del tx, tw, y
        assert moe_gmm.launches == n0 + 4
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        assert same, "MoeGmm's backward is not deterministic"
        ux, uw = x.clone().requires_grad_(), w.clone().requires_grad_()
        uy = moe_gmm.plain(ux, sizes, uw)
        want = (uy,) + torch.autograd.grad(uy, (ux, uw), dy)
        torch.cuda.synchronize()
        errs = {n: _gmm_err(a, b, dtype)
                for n, a, b in zip(("y", "dx", "dw"), runs[0], want)}
        del runs, want, ux, uw, uy
        groups = (f"{len(sizes)} x {sizes[0]}" if len(set(sizes)) == 1
                  else sizes)
        how = "abs+rel" if dtype == torch.bfloat16 else "of each max"
        log(f"[23 MoeGmm] {str(dtype)[6:]} M={M} K={K} N={N} sizes={groups}: "
            f"max err y {errs['y']:.3g} dx {errs['dx']:.3g} dw "
            f"{errs['dw']:.3g} ({how} tol {GMM_TOL[dtype]:g}) against "
            f"autograd of the plain version; rerun bit-identical={same}")
        torch.cuda.empty_cache()


# K4's transposed-weight launches are the backward's dX
MOE_KINDS = dict(K1_KINDS, **{"K4 dX": ("gmm_wgmma_kernel<true>",),
                              "K4": ("gmm_wgmma_kernel", "schedule_kernel")})


def _moe_cut(cfg, **over):
    return dataclasses.replace(cfg, num_layers=MOE_LAYERS,
                               name=cfg.name + f"-{MOE_LAYERS}layer", **over)


def phase_moe_train(cfg):
    """The MoE training main path: full width, 2 layers, seq 4096."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    plan = Plan(remat="none")
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, plan)
    torch.cuda.synchronize()
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", MOE_SEQ,
                                          MOE_BATCH, "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(MOE_STEPS + 1)]
    C = moe.moe_capacity(cfg, MOE_SEQ)
    log(f"[24 moe train] {cfg.name} full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
        f"capacity {C} a row), depth cut to {cfg.num_layers} of 32 layers, "
        f"{cfg.param_count() / 1e9:.3f} B params (float32 master, AdamW "
        f"float32 moments, {cfg.dtype} compute), seq {MOE_SEQ}, batch "
        f"{MOE_BATCH} (train_4k's 256 cut to {MOE_BATCH}), remat "
        f"{plan.remat}; init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    counters = {"moe_gmm": (moe_gmm, "launches"),
                "flash_attention": (flash_attention, "launches"),
                "flash_attention_bwd": (flash_attention_bwd, "launches")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    _reset_k1_counters()
    moe_gmm.tc_launches = moe_gmm.fma_launches = 0
    losses, auxes, walls = [], [], []
    for i in range(MOE_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
        auxes.append(float(metrics["aux"]))
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    want = {"moe_gmm": 6 * cfg.num_layers * MOE_STEPS,
            "flash_attention": cfg.num_layers * MOE_STEPS,
            "flash_attention_bwd": cfg.num_layers * MOE_STEPS}
    assert launches == want, (launches, want)
    paths = _k1_paths(cfg, want["flash_attention"])
    # every K4 launch of the step (bf16, 8-aligned widths) on the tensor
    # cores
    paths["moe_gmm_tc"] = moe_gmm.tc_launches
    paths["moe_gmm_fma"] = moe_gmm.fma_launches
    assert (moe_gmm.tc_launches, moe_gmm.fma_launches) == (
        want["moe_gmm"], 0), paths
    assert all(np.isfinite(losses)) and all(np.isfinite(auxes)), losses
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    log(f"[24 moe train] losses={[round(x, 4) for x in losses]} aux="
        f"{[round(x, 5) for x in auxes]} step_wall_s="
        f"{[round(x, 3) for x in walls]} (the first includes set-up) "
        f"steady_step_s={steady:.3f} tok_per_s="
        f"{MOE_BATCH * MOE_SEQ / steady:.1f} max_memory_allocated_GB="
        f"{peak / 1e9:.2f} launches={launches} (want {want}: K4 "
        f"{6 * cfg.num_layers} a step, 3 forward and 3 dX a layer, all on "
        f"the tensor cores) "
        f"paths={paths}")
    weight_grad, dw_events = moe_gmm.weight_grad, []

    def timed_weight_grad(*a, **k):  # the dW GEMMs between CUDA events
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = weight_grad(*a, **k)
        ev[1].record()
        dw_events.append(ev)
        return out

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with mock.patch.object(moe_gmm, "weight_grad", timed_weight_grad), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[MOE_STEPS])
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    split, by_name = _device_split(prof, MOE_KINDS)
    dw_ms = sum(a.elapsed_time(b) for a, b in dw_events)
    assert len(dw_events) == 3 * cfg.num_layers, len(dw_events)
    del prof
    busy = sum(split.values())
    assert busy > 0 and split["K4"] > 0 and split["K4 dX"] > 0, split
    log(f"[24 moe profile] one step: wall_ms={wall:.1f} device_busy_ms="
        f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall):.3f} (against the "
        f"unprofiled steady step: {max(0.0, 1 - busy / (steady * 1e3)):.3f}) "
        + " ".join(f"{k.replace(' ', '_')}_ms={v:.1f} ({v / busy:.1%})"
                   for k, v in split.items())
        + f" of_which_dW_GEMMs_ms={dw_ms:.1f} ({dw_ms / busy:.1%}, CUDA "
        f"events)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[24 moe profile]   {ms:9.1f} ms  {name}")
    return launches


def _plain_moe_gmm(tokens, group_sizes, w, **_):
    """``ops.moe_gmm`` through autograd of the plain version."""
    return moe_gmm.plain(tokens, group_sizes, w)


def phase_moe_plain(cfg2) -> None:
    """One step's loss, aux, gradient norm and every gradient leaf at
    full width (the 2-layer cut), seq 4096, batch 1, kernel path vs plain
    path, in float32 compute."""
    cfg2 = dataclasses.replace(cfg2, dtype="float32")
    model = build_model(cfg2)
    params = model.init(seed=0)
    stream = make_stream(cfg2, ShapeConfig("t", MOE_SEQ, 1, "train"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    names = [k for k, _ in flatten(params)]

    def loss_and_grads():
        flat = [p.requires_grad_() for p in leaves(params)]
        loss, metrics = model.loss(params, batch, remat="none")
        grads = torch.autograd.grad(loss, flat)
        return float(loss.detach()), float(metrics["aux"].detach()), grads

    t0 = time.perf_counter()
    kern, kaux, kgrads = loss_and_grads()
    t1 = time.perf_counter()
    n0 = (moe_gmm.launches, flash_attention.launches,
          flash_attention_bwd.launches)
    with mock.patch.object(ops, "moe_gmm", _plain_moe_gmm), \
            mock.patch.object(ops, "flash_attention", ref.attention):
        plain, paux, pgrads = loss_and_grads()
    t2 = time.perf_counter()
    assert (moe_gmm.launches, flash_attention.launches,
            flash_attention_bwd.launches) == n0
    knorm = float(global_norm(dict(enumerate(kgrads))))
    pnorm = float(global_norm(dict(enumerate(pgrads))))
    rel_loss = abs(kern - plain) / abs(plain)
    rel_aux = abs(kaux - paux) / abs(paux)
    rel_norm = abs(knorm - pnorm) / abs(pnorm)
    leaf_err = {n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(names, kgrads, pgrads)}
    worst = max(leaf_err, key=leaf_err.get)
    moe_worst = max(v for k, v in leaf_err.items()
                    if "/moe_" in k or "/router" in k)
    log(f"[25 moe kernel vs plain] {cfg2.name} float32 compute, seq "
        f"{MOE_SEQ}, batch 1: loss {kern:.6f} vs {plain:.6f} (rel "
        f"{rel_loss:.3g}, bound {LOSS_REL_BOUND}); aux {kaux:.6g} vs "
        f"{paux:.6g} (rel {rel_aux:.3g}, bound {LOSS_REL_BOUND}); grad_norm "
        f"{knorm:.6f} vs {pnorm:.6f} (rel {rel_norm:.3g}, bound "
        f"{GNORM_REL_BOUND}); worst gradient leaf {worst} "
        f"{leaf_err[worst]:.3g} of its max (router and expert leaves "
        f"{moe_worst:.3g}, bound {MOE_LEAF_BOUND}); {t1 - t0:.1f} s vs "
        f"{t2 - t1:.1f} s")
    assert rel_loss <= LOSS_REL_BOUND and rel_norm <= GNORM_REL_BOUND
    assert rel_aux <= LOSS_REL_BOUND
    assert leaf_err[worst] <= MOE_LEAF_BOUND, leaf_err


# ---------------------------------------------------------------------------
def _stage_walls(res) -> dict:
    """Each stage's wall seconds (its stage_end event's duration)."""
    return {name: round(r.duration_s, 3)
            for name, r in sorted(res.stage_results.items())}


def _serve_workflow(t, runs, knobs):
    """One run of the serve workflow through ``run_workflow`` on the
    card, K1, K2 and K3's counters reset just before and read just
    after; returns (result, launches by kernel, paths)."""
    flash_attention.launches = 0
    flash_attention.tc_launches = flash_attention.fma_launches = 0
    _reset_paged_counters(paged_attention, paged_attention_mq)
    res = run_workflow(t, ProvenanceStore(runs), device="cuda",
                       serve_engine="paged", smoke_batch=WF_SMOKE_BATCH,
                       **knobs)
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in
                (flash_attention, paged_attention, paged_attention_mq)}
    paths = {"flash_attention": {"tensor-cores": flash_attention.tc_launches,
                                 "fma": flash_attention.fma_launches}}
    assert flash_attention.tc_launches == flash_attention.launches > 0, paths
    for mod in (paged_attention, paged_attention_mq):
        if mod.launches:
            paths[mod.__name__.rsplit(".", 1)[1]] = _paged_paths(mod)
    return res, launches, paths


def phase_serve_workflow() -> dict:
    """``serve-qwen2-1.5b`` at full width through the port's
    ``run_workflow``: the paged engine with spec_k 4 (K1 prefills, K3
    verifies; the n-gram proposer decodes nothing, so K2 stays idle),
    then spec_k 0 (K1 and K2), each against ``smoke_serve`` called
    directly on the same weights; returns K1's, K2's and K3's launches
    from the two runs."""
    t = REGISTRY.get("serve-qwen2-1.5b").with_overrides(scale="full")
    cfg = get_config(t.arch)
    totals = {}
    with tempfile.TemporaryDirectory() as runs:
        for knobs in ({"serve_spec_k": SPEC_K}, {"serve_spec_k": 0}):
            res, launches, paths = _serve_workflow(t, runs, knobs)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            done = {c.uid: c.tokens for c in res.final_state}
            assert res.ok and all(ok for ok, _ in res.checks.values()), \
                res.checks
            env = [e for e in res.record.events()
                   if e["kind"] == "environment"]
            assert len(env) == 1 and env[0]["device"].startswith("cuda"), env
            assert env[0]["device_kind"] == torch.cuda.get_device_name(0)
            stats = [r for r in res.record.metrics()
                     if r.get("stage") == "serve"][0]
            key = ("paged_attention_mq" if knobs["serve_spec_k"]
                   else "paged_attention")
            assert launches[key] > 0, launches
            # the same weights (the stage's init from the template's seed)
            # through smoke_serve directly, with the stage's arguments
            model = build_model(cfg)
            params = model.serving_params(model.init(t.data.seed))
            direct, _ = smoke_serve(
                model, params, num_requests=2 * WF_SMOKE_BATCH,
                max_batch=WF_SMOKE_BATCH, max_seq=WF_SMOKE_SEQ + 64,
                vocab_size=cfg.vocab_size, seed=t.data.seed, engine="paged",
                spec_k=knobs["serve_spec_k"])
            del model, params
            torch.cuda.empty_cache()
            same = done == {c.uid: c.tokens for c in direct}
            log(f"[27 serve workflow] {t.name} scale=full ({cfg.num_layers} "
                f"layers, d_model {cfg.d_model}, {cfg.dtype} serving "
                f"parameters) paged spec_k={knobs['serve_spec_k']}: "
                f"requests={len(done)} tokens={int(stats['tokens'])} "
                f"tok_per_s={stats['tok_per_s']:.1f} launches={launches} "
                f"paths={paths}")
            log(f"[27 serve workflow]   completions "
                f"{ {u: v[:8] for u, v in sorted(done.items())} }; "
                f"token-identical to smoke_serve called directly: {same}")
            log(f"[27 serve workflow]   checks {res.checks}; stage walls s "
                f"{_stage_walls(res)}")
            log(f"[27 serve workflow]   environment event: "
                f"{ {k: env[0][k] for k in ('device', 'device_kind', 'device_count', 'backend', 'torch_version', 'cuda_version')} }")
            assert len(done) == 2 * WF_SMOKE_BATCH and same, (done, direct)
    return totals


def _train_workflow(t, runs, failures=None, resume=None):
    return run_workflow(t, ProvenanceStore(runs), device="cuda",
                        failures=failures, resume=resume)


class _Cut(FailureSchedule):
    """A crash at the listed steps: an error no restart policy retries."""

    def check(self, step):
        if step in self.fail_at_steps:
            raise RuntimeError(f"cut at step {step}")


def _committed(runs: str, run_id: str, timeout_s: float = 60.0) -> int:
    """The newest checkpoint a cut run committed, waited for: the cut
    leaves its last background write running in this process, and a
    resume that looked before the write's rename would find nothing."""
    ck = Checkpointer(os.path.join(runs, run_id, "artifacts", "ckpt-train"))
    deadline = time.monotonic() + timeout_s
    while ck.latest_step() is None:
        assert time.monotonic() < deadline, "the cut run committed nothing"
        time.sleep(0.05)
    return ck.latest_step()


def phase_train_workflow() -> dict:
    """``train-qwen2-1.5b`` at the template's own (reduced) scale on the
    card through ``run_workflow``: uninterrupted, with a failure at step
    3 (the envelope restores step 1 and replays), cut at step 3 then
    resumed (its train stage restores onto its placement's mesh, folded
    to the card: an NCCL world of one, ended right after), and under
    ``executor="processes"`` with the eval stage (a pool forked after
    CUDA is up: only the data stage goes to a child); each final state
    against the first, bit for bit.  Returns K1's and
    K1-bwd's launches in the uninterrupted run."""
    # checkpoints every 2 steps, so step 3's failure restores step 1
    t = REGISTRY.get("train-qwen2-1.5b").with_overrides(checkpoint_every=2)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as runs:
            _reset_k1_counters()
            whole = _train_workflow(t, runs)
            launches = {"flash_attention": flash_attention.launches,
                        "flash_attention_bwd": flash_attention_bwd.launches}
            paths = {f"{m.__name__.rsplit('.', 1)[1]}_{p}":
                     getattr(m, f"{p}_launches")
                     for m in (flash_attention, flash_attention_bwd)
                     for p in ("tc", "fma")}
            assert all(launches.values()), launches
            failed = _train_workflow(t, runs, failures=FailureSchedule((3,)))
            store = ProvenanceStore(runs)
            before = set(store.list_runs())
            try:
                _train_workflow(t, runs, failures=_Cut((3,)))
                raise AssertionError("the cut run did not stop")
            except RuntimeError as e:
                assert "cut at step 3" in str(e), e
            (cut_id,) = set(store.list_runs()) - before
            _committed(runs, cut_id)
            resumed = _train_workflow(t, runs, resume=cut_id)
            # the resumed train stage restored onto its placement's mesh,
            # which started an NCCL world of one: end it here, so that no
            # NCCL thread runs beside phases 29-31's host clock
            reshard = [e["kind"] for e in resumed.record.events()
                       if e["kind"].startswith("reshard")]
            assert reshard == ["reshard"], reshard
            dist.destroy_process_group()
            # a process pool forked after this process initialised CUDA:
            # only the data stage (no tensor) goes to a child
            pooled = run_workflow(t, ProvenanceStore(runs), device="cuda",
                                  with_eval=True, executor="processes",
                                  workers=1)
            workers = {e["stage"]: e["worker"] for e in
                       pooled.record.events() if e["kind"] == "stage_worker"}
            assert workers["data"].startswith("pid:"), workers
            assert workers["train"] == workers["eval"] == "inline", workers
            kinds = [e["kind"] for e in failed.record.events()]
            assert "failure" in kinds and "restore" in kinds, kinds
            same = {}
            for name, res in (("failure at step 3", failed),
                              ("resume of a run cut at step 3", resumed),
                              ("--executor processes, with eval", pooled)):
                same[name] = all(
                    torch.equal(x, y) for (_, x), (_, y)
                    in zip(flatten(whole.final_state),
                           flatten(res.final_state)))
            rows = [r for r in whole.record.metrics() if "loss" in r]
            cfg = reduced(get_config(t.arch))
            log(f"[28 train workflow] {t.name} scale={t.scale} "
                f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.dtype} compute) {len(rows)} steps: losses "
                f"{[round(r['loss'], 4) for r in rows]} launches={launches} "
                f"paths={paths}")
            log(f"[28 train workflow]   step_time_s (metrics.jsonl) "
                f"{[round(r['step_time_s'], 4) for r in rows]}; stage walls s "
                f"{_stage_walls(whole)}")
            (ev,) = [e for e in pooled.record.events() if e["kind"] == "eval"]
            log(f"[28 train workflow]   --executor processes: stage "
                f"workers {workers}; eval loss {ev['loss']:.4f}")
            for name, res in (("uninterrupted", whole),
                              ("failure at step 3", failed),
                              ("resume of a run cut at step 3", resumed),
                              ("--executor processes, with eval", pooled)):
                log(f"[28 train workflow]   {name}: ok={res.ok} checks "
                    f"{ {k: v[0] for k, v in res.checks.items()} }" + (
                        f"; final state bit-identical to uninterrupted: "
                        f"{same[name]}" if name in same else ""))
            assert whole.ok and failed.ok and resumed.ok and pooled.ok
            assert resumed.stage_results["data"].resumed
            assert all(same.values()), same
    finally:
        torch.use_deterministic_algorithms(False)
    return launches


# ---------------------------------------------------------------------------
def phase_card_catalog() -> None:
    """The card enters the catalog only by registration: none of its
    slices in the default catalog, two generation bumps for ``h100-1``
    and ``h100-8``; the one-card plan of train_4k at each of
    ``CARD_BATCHES``."""
    default = [s.name for s in build_catalog()]
    assert [s.name for s in CATALOG] == default, "the catalog moved"
    assert not any(n.startswith("h100") for n in default), default
    gen0 = catalog_generation()
    slices = register_card()
    assert catalog_generation() == gen0 + 2, (gen0, catalog_generation())
    chip = slices[0].chip
    log(f"[29 card] {chip.name}: {chip.peak_bf16_flops / 1e12:.1f} TFLOP/s "
        f"bf16, {chip.hbm_bytes / 1e9:.0f} GB at {chip.hbm_bw / 1e12:.2f} "
        f"TB/s, ${chip.price_per_hour:.2f}/card-hour; registered "
        f"{[s.name for s in slices]} (catalog generation {gen0} -> "
        f"{catalog_generation()}, {len(CATALOG)} slices)")
    for gb in CARD_BATCHES:
        shape = derived_shape("train_4k", gb)
        (choice,) = plan(ResourceIntent(arch="qwen2-1.5b", shape=shape,
                                        chip_generation=chip.name,
                                        max_chips=1), top_k=1)
        assert choice.slice.name == f"{chip.name}-1", choice.summary
        log(f"[29 card] qwen2-1.5b {shape}: {choice.summary} "
            f"bytes_per_device={choice.est.bytes_per_device / 1e9:.2f} GB")


def _tree_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 1e9


def phase_card_train_workflow(runs: str, n_steps: int = CARD_FIT_STEPS):
    """``train-qwen2-1.5b`` at full width through ``run_workflow`` with an
    intent naming the card, at each of ``CARD_BATCHES``, ``n_steps`` steps
    a run: each run's launches by path, peak memory and plan; its final
    checkpoint removed after it.  Returns K1's and K1-bwd's launches over
    the runs, and each run's id and plan doc by global batch."""
    cfg = get_config("qwen2-1.5b")
    totals = {"flash_attention": 0, "flash_attention_bwd": 0}
    out = {}
    for gb in CARD_BATCHES:
        shape = derived_shape("train_4k", gb)
        t = REGISTRY.get("train-qwen2-1.5b").with_overrides(scale="full",
                                                             shape=shape)
        intent = ResourceIntent(arch=t.arch, shape=shape,
                                chip_generation="h100", max_chips=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_k1_counters()
        load0 = os.getloadavg()
        t0 = time.perf_counter()
        res = run_workflow(t, ProvenanceStore(runs), device="cuda",
                           intent=intent, steps_override=n_steps)
        wall = time.perf_counter() - t0
        load1 = os.getloadavg()
        peak = torch.cuda.max_memory_allocated()
        launches = {"flash_attention": flash_attention.launches,
                    "flash_attention_bwd": flash_attention_bwd.launches}
        doc = res.record.manifest["plan"]
        est = res.plan_choice.est
        # remat full runs each layer's forward again in the backward
        passes = 2 if doc["remat"] == "full" else 1
        want = cfg.num_layers * n_steps * doc["microbatch"]
        paths = {f"{m.__name__.rsplit('.', 1)[1]}_{p}":
                 getattr(m, f"{p}_launches")
                 for m in (flash_attention, flash_attention_bwd)
                 for p in ("tc", "fma")}
        rows = [r for r in res.record.metrics() if "loss" in r]
        steps = [r["step_time_s"] for r in rows]
        env = [e for e in res.record.events() if e["kind"] == "environment"]
        ckpt = os.path.join(res.record.artifacts_dir, "ckpt-train")
        ckpt_gb = _tree_gb(ckpt)
        shutil.rmtree(ckpt)
        log(f"[30 card train workflow] {t.name} scale=full {shape} "
            f"({cfg.num_layers} layers, d_model {cfg.d_model}, seq "
            f"{TRAIN_SEQ}, global batch {gb}) {len(rows)} steps: plan "
            f"{doc['slice']} chip={doc['chip']} remat={doc['remat']} "
            f"microbatch={doc['microbatch']} est_step_s="
            f"{doc['est_step_s']:.4f}; losses "
            f"{[round(r['loss'], 4) for r in rows]} launches={launches} "
            f"(want {passes * want} and {want}) paths={paths}")
        log(f"[30 card train workflow]   step_time_s (metrics.jsonl) "
            f"{[round(x, 4) for x in steps]} median after the first "
            f"{statistics.median(steps[1:]):.4f}; host load average (1, 5, "
            f"15 min) at the run's start {[round(x, 2) for x in load0]} and "
            f"end {[round(x, 2) for x in load1]} on {os.cpu_count()} cores; "
            f"max_memory_allocated_GB="
            f"{peak / 1e9:.2f} against the plan's bytes_per_device "
            f"{est.bytes_per_device / 1e9:.2f} GB (x"
            f"{peak / est.bytes_per_device:.2f}); final checkpoint "
            f"{ckpt_gb:.2f} GB, removed; run wall {wall:.1f} s")
        log(f"[30 card train workflow]   checks {res.checks}; stage walls s "
            f"{_stage_walls(res)}; environment "
            f"{[(e['stage'], e['device'], e['device_kind']) for e in env]}")
        assert launches == {"flash_attention": passes * want,
                            "flash_attention_bwd": want}, (launches, want)
        assert paths["flash_attention_fma"] == 0, paths
        assert paths["flash_attention_bwd_fma"] == 0, paths
        assert res.ok and all(ok for ok, _ in res.checks.values()), res.checks
        assert doc["slice"] == "h100-1" and doc["chip"] == "h100", doc
        assert doc["kind"] == "train", doc
        assert [e["stage"] for e in env] == ["train"], env
        assert env[0]["device"].startswith("cuda"), env
        for k, v in launches.items():
            totals[k] += v
        out[gb] = {"run_id": res.record.run_id, "plan": doc}
        del res
        torch.cuda.empty_cache()
    return totals, out


def phase_card_calibrate_explore(runs: str, wf_runs: dict) -> None:
    """Harvest the card's runs (one sample each under (h100, train)),
    fit and activate through a workflow of the calibrate stage, then
    explore the card's slices at the same arch and shapes under that
    calibration."""
    samples = calibrate.harvest_runs_dir(runs)
    by_run = {s.source: s for s in samples}
    assert len(samples) == len(by_run) == len(wf_runs), samples
    assert sorted(by_run) == sorted(f"run:{r['run_id']}"
                                    for r in wf_runs.values()), by_run
    assert all((s.chip, s.kind) == ("h100", "train") for s in samples)
    spec = ExploreSpec(archs=("qwen2-1.5b",), shapes=("train_4k",),
                       chip_counts=(1, 8), global_batches=CARD_BATCHES,
                       chip_generation="h100")
    g = StageGraph("calibrate-explore")
    store_path = os.path.join(runs, "calibration.json")
    g.add(CalibrateStage(store_path=store_path, runs_root=runs,
                         activate=True))
    g.add(ExploreStage(spec=spec), depends_on=("calibrate",))
    res = run_workflow(REGISTRY.get("train-qwen2-1.5b"),
                       ProvenanceStore(os.path.join(runs, "advice")),
                       graph=g, device="cuda")
    cal = calibrate.active()
    assert cal is not None and res.ok, res.stage_results
    cell = cal.cell("h100", "train")
    assert cell is not None and cell.n_samples == len(CARD_BATCHES), cal
    events = {e["kind"]: e for e in res.record.events()
              if e["kind"] in ("calibrate", "explore")}
    log(f"[31 card calibrate] harvested {len(samples)} samples; cell "
        f"h100/train mode={cell.mode} scale={cell.scale:.4f} n="
        f"{cell.n_samples} residual={cell.residual:.4f} (bound "
        f"{CARD_FIT_RESIDUAL}); calibrate event {events['calibrate']}")
    for gb, r in sorted(wf_runs.items()):
        s = by_run[f"run:{r['run_id']}"]
        calibrated = float(cell.predict(s.compute_s, s.memory_s,
                                        s.collective_s))
        (replanned,) = plan(ResourceIntent(
            arch="qwen2-1.5b", shape=derived_shape("train_4k", gb),
            chip_generation="h100", max_chips=1), top_k=1)
        log(f"[31 card calibrate] global batch {gb}: measured median step "
            f"{s.measured_step_s:.4f} s over {int(s.weight)} steps; "
            f"uncalibrated estimate {r['plan']['est_step_s']:.4f} s (x"
            f"{s.measured_step_s / r['plan']['est_step_s']:.3f}); "
            f"calibrated {calibrated:.4f} s (rel err "
            f"{(calibrated - s.measured_step_s) / s.measured_step_s:+.4f}); "
            f"re-planned under the calibration: {replanned.summary}")
    path = events["explore"]["report"]
    with open(path, encoding="utf-8") as f:
        report = f.read()
    with open(path.rsplit(".", 1)[0] + ".json", encoding="utf-8") as f:
        doc = json.load(f)
    log(f"[31 card explore] {events['explore']}; calibration generation "
        f"{doc['calibration_generation']} active; report rows:")
    for line in report.splitlines():
        if line.startswith("| ") and "h100" in line:
            log(f"[31 card explore]   {line}")
    assert doc["calibration_generation"] == cal.generation > 0, doc
    assert doc["frontier"], doc
    assert cell.residual <= CARD_FIT_RESIDUAL, cell
    calibrate.deactivate()
    unregister_card()

# ---------------------------------------------------------------------------
# whisper-large-v3 and phi-3-vision-4.2b (phases 32-35)

# K1's and K1-bwd's shapes on this slice's main paths (phase 32):
# (name, B, S, T, H, KH, D, causal) — whisper's encoder self-attention
# over its 1500 frames, its decoder's causal self-attention and its cross
# attention of 4096 tokens against the 1500 frames, at train batch 2;
# phi-3-vision's causal attention at head dim 96, train batch 1
SLICE_K1_CASES = (
    ("whisper encoder", 2, 1500, 1500, 20, 20, 64, False),
    ("whisper decoder", 2, 4096, 4096, 20, 20, 64, True),
    ("whisper cross", 2, 4096, 1500, 20, 20, 64, False),
    ("phi-3-vision", 1, 4096, 4096, 32, 32, 96, True),
)
# whisper-large-v3 training: train_4k's length, its global batch of 256
# cut to 2; remat full (the decoder blocks; the encoder is kept, as in the
# reference)
WH_SEQ, WH_BATCH, WH_STEPS, WH_REMAT = 4096, 2, 4, "full"
# whisper serving: 8 requests of 1500 frames, prompts of two lengths
# (exact-length admission groups of 4), 16 new tokens each, 4 slots; the
# random embedding scaled by WH_EMBED_SCALE (std 0.0044 -> 0.88) and the
# frames drawn at std 1, the size of the sinusoidal positions, so that
# the prompt and the audio, not only the positions, decide the tokens
WH_PROMPTS, WH_MAX_BATCH, WH_MAX_NEW = (24, 40) * 4, 4, 16
WH_EMBED_SCALE, WH_FRAME_STD = 200.0, 1.0
# phi-3-vision training: train_4k's length, batch 1, remat full, full
# depth (its 61 GB of float32 state and gradients fit).  Its learning rate:
# at d_model 3072 with an untied head, AdamW's first steps (each weight
# moved by about the learning rate) at lr 1e-4 and at the templates'
# 2e-3 raised the loss within 6 steps (NVIDIA H100 80GB HBM3, 700 W:
# 10.59 -> 12.93 at step 3; 11.61 -> 14.04 over the template's run; at
# 1e-5, 10.62 -> 9.25 over the template's run: the recipe's, not the
# port's arithmetic, whose curve is the reference's on the CPU,
# tests/test_torch_vlm.py).  Phases 34 and 35 train it at PV_LR after one
# warmup step (phase 35 through the template's ``optimizer.*`` overrides)
PV_SEQ, PV_BATCH, PV_STEPS, PV_REMAT = 4096, 1, 4, "full"
PV_LR = 1e-5
# phi-3-vision serving: 8 image requests, prompts of the 576 image
# positions and 24 or 40 text tokens, 16 new tokens each, 4 slots
PV_TEXT, PV_MAX_BATCH, PV_MAX_NEW = (24, 40) * 4, 4, 16
# the two templates at scale="full" planned for the card (phase 35):
# (template, global batch of train_4k, template overrides)
SLICE_TEMPLATES = (
    ("train-whisper-large-v3", 2, {}),
    ("train-phi-3-vision-4.2b", 1, {"optimizer.lr": PV_LR,
                                    "optimizer.warmup_steps": 1}))
SLICE_KINDS = dict(K1_KINDS)


def phase_slice_kernels(gen) -> dict:
    """K1 with its LSE and K1-bwd at whisper's and phi-3-vision's
    attention shapes, in both dtypes, against their plain versions (bf16
    on the tensor cores at D 64 and D 96); K2 at phi-3-vision's serving
    shape and K3 at its verify shape (T = SPEC_K + 1; D 96: bf16 on the
    FMA walk by the page walk's rule), hot and cold, in both dtypes.
    Returns K3's bf16 row."""
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, S, T, H, KH, D, causal in SLICE_K1_CASES:
            _k1_train_case(name, dtype, B, S, T, H, KH, D, 0, 0, gen,
                           phase=32, causal=causal)
            torch.cuda.empty_cache()
    cfg = get_config("phi-3-vision-4.2b")
    prompts = [cfg.num_image_tokens + t for t in PV_TEXT[:PV_MAX_BATCH]]
    max_pages = -(-(max(prompts) + PV_MAX_NEW) // PAGE)
    rng = np.random.default_rng(32)
    for dtype in (torch.bfloat16, torch.float32):
        r = _paged_case("K2", "phi-3-vision serving (first decode step)",
                        dtype, PV_MAX_BATCH, 1, cfg.num_kv_heads,
                        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, PAGE,
                        max_pages, [n + 1 for n in prompts], gen, rng,
                        cold=True, phase="32 K2")
        assert r["path"].startswith("fma"), r  # D 96: no tensor-core walk
    # the verify batch of phase 34's speculative run: 4 slots, T = SPEC_K
    # + 1 rows each from the first round's base lengths, 32 heads of 96
    # (G = 1), pages of 16
    max_pages = -(-(max(prompts) + PV_MAX_NEW + SPEC_K) // PAGE)
    k3 = None
    for dtype in (torch.bfloat16, torch.float32):
        r = _paged_case("K3", "phi-3-vision verify (T = SPEC_K + 1)", dtype,
                        PV_MAX_BATCH, SPEC_K + 1, cfg.num_kv_heads,
                        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, PAGE,
                        max_pages, [n + 1 for n in prompts], gen, rng,
                        cold=True, phase="32 K3")
        assert r["path"].startswith("fma"), r  # D 96: no tensor-core walk
        k3 = k3 or r
    return k3


def _modal_requests(prompts, max_new, key, rows, d, vocab, seed,
                    std=0.02):
    """One request a prompt length of ``prompts``, each with its own
    ``key`` input of ``rows`` x ``d`` (std 0.02, as the data stream makes
    them, unless ``std`` says otherwise)."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                    max_new_tokens=max_new,
                    extra={key: (std * rng.standard_normal((rows, d))
                                 ).astype(np.float32)})
            for i, n in enumerate(prompts)]


def _serve(model, params, reqs, **kw):
    eng = ServeEngine(model, params, eos_id=-1, **kw)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    wall = time.perf_counter() - t0
    return {c.uid: c.tokens for c in done}, wall, eng


def _slice_train(tag, cfg, seq, batch, steps, remat, want_fwd, want_bwd,
                 opt=OptimizerConfig(lr=1e-4, warmup_steps=2,
                                     total_steps=100)):
    """Train ``cfg`` at full width through ``make_train_step``: K1's and
    K1-bwd's counters reset just before ``steps`` steps and read just
    after (every bf16 launch on the tensor cores), then one profiled
    step's device split.  Returns K1's and K1-bwd's launches."""
    model = build_model(cfg)
    plan = Plan(remat=remat)
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, plan)
    torch.cuda.synchronize()
    step = make_train_step(model, opt, plan)
    stream = make_stream(cfg, ShapeConfig("train_4k-cut", seq, batch,
                                          "train"))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(steps + 1)]
    for b in batches:  # the train stage's bf16 casts of the stub inputs
        for k in ("frames", "image_embeds"):
            if k in b:
                b[k] = b[k].to(torch.bfloat16)
    log(f"[{tag} train] {cfg.name} full width, {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}"
        f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, {cfg.param_count() / 1e9:.3f} B params (float32 "
        f"master, AdamW float32 moments, {cfg.dtype} compute), seq {seq}, "
        f"batch {batch} (train_4k's 256 cut to {batch}), remat {remat}, lr "
        f"{opt.lr:g} after {opt.warmup_steps} warmup steps; "
        f"inputs {sorted((k, tuple(v.shape)) for k, v in batches[0].items())}"
        f"; init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_k1_counters()
    losses, walls = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))  # waits for the step
        walls.append(time.perf_counter() - t0)
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    assert launches == {"flash_attention": want_fwd * steps,
                        "flash_attention_bwd": want_bwd * steps}, launches
    paths = {f"{m.__name__.rsplit('.', 1)[1]}_{p}": getattr(m, f"{p}_launches")
             for m in (flash_attention, flash_attention_bwd)
             for p in ("tc", "fma")}
    assert paths["flash_attention_fma"] == 0, paths
    assert paths["flash_attention_bwd_fma"] == 0, paths
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    log(f"[{tag} train] losses={[round(x, 4) for x in losses]} step_wall_s="
        f"{[round(x, 3) for x in walls]} (the first includes set-up) "
        f"steady_step_s={steady:.3f} tok_per_s={batch * seq / steady:.1f} "
        f"max_memory_allocated_GB={peak / 1e9:.2f} launches={launches} "
        f"(want {want_fwd} and {want_bwd} a step) paths={paths}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[steps])
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    split, by_name = _device_split(prof, SLICE_KINDS)
    del prof
    busy = sum(split.values())
    assert busy > 0 and split["K1 forward"] > 0 and split["K1-bwd"] > 0, split
    log(f"[{tag} train profile] one step: wall_ms={wall:.1f} device_busy_ms="
        f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall):.3f} (against the "
        f"unprofiled steady step: {max(0.0, 1 - busy / (steady * 1e3)):.3f}) "
        + " ".join(f"{k.replace(' ', '_')}_ms={v:.1f} ({v / busy:.1%})"
                   for k, v in split.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag} train profile]   {ms:9.1f} ms  {name}")
    del state, batches, step, model
    torch.cuda.empty_cache()
    return launches


def phase_whisper(cfg) -> dict:
    """whisper-large-v3 at full width: 1500-frame requests on the fused
    engine in exact-length groups, the greedy tokens of each group held
    against the same group prefilled and decoded directly; then training
    at seq 4096, batch 2.  Returns K1's and K1-bwd's main-path
    launches."""
    model = build_model(cfg)
    t0 = time.perf_counter()
    master = model.init(seed=0)
    master["embed"].mul_(WH_EMBED_SCALE)
    params = model.serving_params(master)
    del master
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = _modal_requests(WH_PROMPTS, WH_MAX_NEW, "frames",
                           cfg.encoder_frames, cfg.d_model, cfg.vocab_size, 33,
                           std=WH_FRAME_STD)
    max_seq = max(WH_PROMPTS) + WH_MAX_NEW
    _reset_k1_counters()
    got, wall, eng = _serve(model, params, reqs, max_batch=WH_MAX_BATCH,
                            max_seq=max_seq)
    serve_k1 = flash_attention.launches
    k1_paths = {"tensor-cores": flash_attention.tc_launches,
                "fma": flash_attention.fma_launches}
    keys = sorted({eng._group_key(r)[:2] for r in reqs})
    # 2 groups (one a length), each K1 2 a decoder layer + 1 an encoder
    want_k1 = 2 * (2 * cfg.num_layers + cfg.encoder_layers)
    assert serve_k1 == want_k1 and k1_paths["fma"] == 0, (serve_k1, k1_paths)
    assert keys == [("exact", n) for n in sorted(set(WH_PROMPTS))], keys
    toks = sum(len(v) for v in got.values())
    log(f"[33 whisper serve] {cfg.name} full width ({cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype} "
        f"serving parameters, embedding x{WH_EMBED_SCALE:g}; init "
        f"{init_s:.1f} s): {len(reqs)} requests of {cfg.encoder_frames} "
        f"frames (std {WH_FRAME_STD:g}), prompts {sorted(set(WH_PROMPTS))} -> "
        f"admission groups {keys}, {WH_MAX_BATCH} slots: tokens={toks} "
        f"wall_s={wall:.3f} tok_per_s={toks / wall:.1f} (first run, set-up "
        f"included) K1 launches={serve_k1} paths={k1_paths}")
    by_len = {}
    for r in reqs:
        by_len.setdefault(len(r.prompt), []).append(r)
    for n, group in sorted(by_len.items()):
        direct = _direct(model, params, group, max_seq, WH_MAX_NEW)[0]
        mine = [got[r.uid] for r in group]
        log(f"[33 whisper serve]   group of length {n}: uids "
            f"{[r.uid for r in group]} tokens {[t[:6] for t in mine]}; "
            f"identical to a direct prefill/decode of the group: "
            f"{mine == direct}")
        assert mine == direct, (n, mine, direct)
    distinct = len({tuple(t) for t in got.values()})
    log(f"[33 whisper serve]   {distinct} distinct token sequences of "
        f"{len(got)}")
    assert distinct > 1, got
    del model, params, eng
    torch.cuda.empty_cache()
    want_fwd = cfg.encoder_layers + 2 * cfg.num_layers * (
        2 if WH_REMAT == "full" else 1)
    train = _slice_train("33 whisper", cfg, WH_SEQ, WH_BATCH, WH_STEPS, WH_REMAT,
                         want_fwd, cfg.encoder_layers + 2 * cfg.num_layers)
    return {"flash_attention": serve_k1 + train["flash_attention"],
            "flash_attention_bwd": train["flash_attention_bwd"]}


def phase_phi3v(cfg) -> dict:
    """phi-3-vision-4.2b at full width: image requests on the fused and
    the paged engine (K2's launches by path, main path; at D 96 the page
    walk runs on FMAs), identical tokens in float32 compute and the
    agreeing share in bf16; then training at seq 4096, batch 1.  Returns
    K1's, K1-bwd's and K2's main-path launches."""
    model = build_model(cfg)
    t0 = time.perf_counter()
    master = model.init(seed=0)
    params = model.serving_params(master)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_img = cfg.num_image_tokens
    prompts = [n_img + t for t in PV_TEXT]
    max_seq = max(prompts) + PV_MAX_NEW
    reqs = _modal_requests(prompts, PV_MAX_NEW, "image_embeds", n_img,
                           cfg.d_model, cfg.vocab_size, 34)
    kw = dict(max_batch=PV_MAX_BATCH, max_seq=max_seq, page_size=PAGE)
    got = {}
    for engine in ("fused", "paged"):
        _reset_k1_counters()
        _reset_paged_counters(paged_attention)
        got[engine], wall, eng = _serve(model, params, reqs, engine=engine,
                                        **kw)
        k1 = flash_attention.launches
        toks = sum(len(v) for v in got[engine].values())
        line = (f"[34 phi-3-vision serve] {engine}: {len(reqs)} requests, "
                f"prompts {sorted(set(prompts))} ({n_img} image positions "
                f"+ text), {PV_MAX_BATCH} slots: tokens={toks} wall_s="
                f"{wall:.3f} tok_per_s={toks / wall:.1f} K1 launches={k1} "
                f"(tensor-cores {flash_attention.tc_launches})")
        assert k1 > 0 and flash_attention.fma_launches == 0
        if engine == "paged":
            k2 = paged_attention.launches
            k2_paths = {"tensor-cores": paged_attention.tc_launches,
                        "fma": paged_attention.fma_launches,
                        "merged": paged_attention.merge_launches}
            # bf16 at D 96: the page walk's rule sends it to the FMAs
            assert k2 > 0 and k2_paths["fma"] == k2, k2_paths
            assert eng.pool.pages_in_use == 0 and eng.pool.prefix_hits == 0
            line += (f" K2 launches={k2} paths={k2_paths} prefix_hits="
                     f"{eng.pool.prefix_hits}")
            paged_k1 = k1
        log(line)
    # the paged engine with n-gram speculation on the same requests (the
    # counters reset just before, read just after: K3 at D 96 on its FMA
    # walk, no K2: every round is a verify)
    kw_spec = dict(kw, max_seq=max_seq + SPEC_K)
    _reset_k1_counters()
    _reset_paged_counters(paged_attention, paged_attention_mq)
    got["spec"], wall, eng = _serve(model, params, reqs, engine="paged",
                                    spec_k=SPEC_K, **kw_spec)
    spec_k1, k3 = flash_attention.launches, paged_attention_mq.launches
    k3_paths = {"tensor-cores": paged_attention_mq.tc_launches,
                "fma": paged_attention_mq.fma_launches,
                "merged": paged_attention_mq.merge_launches}
    st = eng.kv_stats()
    toks = sum(len(v) for v in got["spec"].values())
    assert k3 > 0 and k3_paths["fma"] == k3, k3_paths
    assert paged_attention.launches == 0 and st["pages_in_use"] == 0
    assert st["spec_tokens"] == toks - len(reqs), st
    spec_agree = sum(a == b for u in got["paged"]
                     for a, b in zip(got["paged"][u], got["spec"][u]))
    log(f"[34 phi-3-vision serve] paged spec_k={SPEC_K} (n-gram): tokens="
        f"{toks} wall_s={wall:.3f} tok_per_s={toks / wall:.1f} accept_rate="
        f"{st['spec_accept_rate']:.4f} tokens_per_round="
        f"{st['spec_tokens_per_round']:.3f} slot_rounds={st['spec_rounds']} "
        f"K1 launches={spec_k1} K3 launches={k3} paths={k3_paths}; bf16 "
        f"tokens agree with the paged run's at {spec_agree}/{toks} positions")
    agree = sum(a == b for u in got["fused"]
                for a, b in zip(got["fused"][u], got["paged"][u]))
    total = sum(len(v) for v in got["fused"].values())
    log(f"[34 phi-3-vision serve] {cfg.name} full width ({cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, {cfg.dtype} serving parameters; init {init_s:.1f} "
        f"s): fused and paged tokens agree at {agree}/{total} positions in "
        f"bf16 (the dense decode read and K2 round at other points)")
    del params, eng
    torch.cuda.empty_cache()
    # identity in float32 compute: the same weights, one admission group
    # of 4 in which uid 100 is uid 0's prompt and image again (so the two
    # share uid 0's full prompt pages)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = f32.serving_params(master)
    reqs2 = [reqs[0], dataclasses.replace(reqs[0], uid=100)] + reqs[1:3]
    res = {e: _serve(f32, params, reqs2, engine=e, **kw) for e in
           ("fused", "paged")}
    same = res["fused"][0] == res["paged"][0]
    hits = res["paged"][2].pool.prefix_hits
    log(f"[34 phi-3-vision serve] float32 compute, {len(reqs2)} requests "
        f"(uid 100 is uid 0's prompt and image again): fused and paged "
        f"tokens identical: {same}; uid 100 == uid 0: "
        f"{res['paged'][0][100] == res['paged'][0][0]}; prefix_hits={hits} "
        f"(uid 100's {prompts[0] // PAGE} full prompt pages)")
    assert same and res["paged"][0][100] == res["paged"][0][0], res
    assert hits == prompts[0] // PAGE, hits
    # speculation in float32 compute: the 8 image requests with and
    # without it on the paged engine, token for token (a divergence only
    # at a near-tie of the target)
    base, spec = (_serve(f32, params, reqs, engine="paged", spec_k=k,
                         **kw_spec)[0] for k in (0, SPEC_K))
    same = _near_tie_divergences(
        "34 phi-3-vision spec f32", f32, params, base, spec,
        {r.uid: r.prompt for r in reqs}, {r.uid: r.extra for r in reqs})
    log(f"[34 phi-3-vision spec f32] {same}/{len(base)} requests "
        f"token-identical on the paged engine with spec_k {SPEC_K} and "
        f"without")
    del f32, params, res, master, model
    torch.cuda.empty_cache()
    mult = 2 if PV_REMAT == "full" else 1
    train = _slice_train("34 phi-3-vision", cfg, PV_SEQ, PV_BATCH, PV_STEPS,
                         PV_REMAT, mult * cfg.num_layers, cfg.num_layers,
                         OptimizerConfig(lr=PV_LR, warmup_steps=1,
                                         total_steps=100))
    return {"flash_attention": (paged_k1 + spec_k1
                                + train["flash_attention"]),
            "flash_attention_bwd": train["flash_attention_bwd"],
            "paged_attention": k2, "paged_attention_mq": k3}


def phase_slice_workflows(runs: str) -> dict:
    """``train-whisper-large-v3`` and ``train-phi-3-vision-4.2b`` at
    ``scale="full"`` through ``run_workflow``, planned for the card's
    one-card slice (the plan's remat and microbatch), ``CARD_STEPS``
    steps each: launches by path, the checks, the peak beside the plan's
    ``bytes_per_device``; each final checkpoint removed after its run.
    Returns K1's and K1-bwd's launches over the runs."""
    register_card()
    totals = {"flash_attention": 0, "flash_attention_bwd": 0}
    for name, gb, over in SLICE_TEMPLATES:
        shape = derived_shape("train_4k", gb)
        t = REGISTRY.get(name).with_overrides(scale="full", shape=shape,
                                              **over)
        cfg = get_config(t.arch)
        free = shutil.disk_usage(runs).free
        ckpt_need = 3 * 4 * cfg.param_count()  # p, m and v in float32
        assert free > 1.2 * ckpt_need, (
            f"{name}: {free / 1e9:.1f} GB free for a {ckpt_need / 1e9:.1f} "
            f"GB checkpoint")
        intent = ResourceIntent(arch=t.arch, shape=shape,
                                chip_generation="h100", max_chips=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_k1_counters()
        t0 = time.perf_counter()
        res = run_workflow(t, ProvenanceStore(runs), device="cuda",
                           intent=intent, steps_override=CARD_STEPS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"flash_attention": flash_attention.launches,
                    "flash_attention_bwd": flash_attention_bwd.launches}
        paths = {f"{m.__name__.rsplit('.', 1)[1]}_{p}":
                 getattr(m, f"{p}_launches")
                 for m in (flash_attention, flash_attention_bwd)
                 for p in ("tc", "fma")}
        doc = res.record.manifest["plan"]
        est = res.plan_choice.est
        rows = [r for r in res.record.metrics() if "loss" in r]
        steps = [r["step_time_s"] for r in rows]
        ckpt = os.path.join(res.record.artifacts_dir, "ckpt-train")
        ckpt_gb = _tree_gb(ckpt)
        shutil.rmtree(ckpt)
        recompute = 2 if doc["remat"] in ("full", "dots") else 1
        per = cfg.num_layers * (2 if cfg.is_encoder_decoder else 1)
        want_bwd = (per + cfg.encoder_layers) * CARD_STEPS * doc["microbatch"]
        want_fwd = ((recompute * per + cfg.encoder_layers) * CARD_STEPS
                    * doc["microbatch"])
        log(f"[35 slice workflow] {t.name} scale=full {shape} "
            f"({cfg.num_layers} layers, d_model {cfg.d_model}, seq "
            f"{TRAIN_SEQ}, global batch {gb}) {len(rows)} steps, optimizer "
            f"lr {t.optimizer.lr:g} warmup {t.optimizer.warmup_steps} "
            f"(overrides {over or 'none'}): plan "
            f"{doc['slice']} chip={doc['chip']} remat={doc['remat']} "
            f"microbatch={doc['microbatch']} est_step_s="
            f"{doc['est_step_s']:.4f}; losses "
            f"{[round(r['loss'], 4) for r in rows]} launches={launches} "
            f"(want {want_fwd} and {want_bwd}) paths={paths}")
        log(f"[35 slice workflow]   step_time_s {[round(x, 4) for x in steps]}"
            f" median after the first {statistics.median(steps[1:]):.4f}; "
            f"max_memory_allocated_GB={peak / 1e9:.2f} against the plan's "
            f"bytes_per_device {est.bytes_per_device / 1e9:.2f} GB (x"
            f"{peak / est.bytes_per_device:.2f}); disk free before "
            f"{free / 1e9:.1f} GB; final checkpoint {ckpt_gb:.2f} GB, removed;"
            f" run wall {wall:.1f} s")
        log(f"[35 slice workflow]   checks {res.checks}; stage walls s "
            f"{_stage_walls(res)}")
        assert launches == {"flash_attention": want_fwd,
                            "flash_attention_bwd": want_bwd}, launches
        assert paths["flash_attention_fma"] == 0, paths
        assert paths["flash_attention_bwd_fma"] == 0, paths
        assert res.ok and all(ok for ok, _ in res.checks.values()), res.checks
        assert doc["slice"] == "h100-1" and doc["chip"] == "h100", doc
        for k, v in launches.items():
            totals[k] += v
        del res
        torch.cuda.empty_cache()
    unregister_card()
    return totals



# ---------------------------------------------------------------------------
def _k5_state_case(name, dtype, B, S, Din, N, gen, tag="36",
                   plain_reps=2, exact=True) -> dict:
    """K5 with its final state at a prefill's shape against its plain
    version (``ref.ssm_scan_chunked`` at K5's chunk): the state (and, in
    float32, y) against the scan run in float64, within max(2e-5, 4x the
    float32 plain version's own error), as phase 17 holds the
    checkpoints (without ``exact``: against the plain version's float32
    scan, within 2e-5); bf16 y at 2e-2 abs+rel.  ``plain_reps`` 0 times
    the plain version by the check's own call (CUDA events)."""
    xs = _ssm_inputs(gen, dtype, B, S, Din, N)
    y, h = ssm_scan.ssm_scan_cuda(*xs, with_state=True)
    want, first_ms = _events_ms(lambda: ref.ssm_scan_chunked(
        *xs, chunk=ref.SSM_CHUNK))
    against = "float64" if exact else "the plain version"
    exact = _ssm_fwd_ckpt64(*xs) if exact else (want[0], None, want[1])
    torch.cuda.synchronize()
    pairs = [(h, want[1], exact[2])]
    if dtype == torch.float32:
        pairs.append((y, want[0], exact[0]))
    plain = max(_abs_rel_err(w, e) for _, w, e in pairs)
    bound = max(TOL[torch.float32], 4 * plain)
    each = ", ".join(f"{n} {_abs_rel_err(g, e):.3g} (plain "
                     f"{_abs_rel_err(w, e):.3g})"
                     for n, (g, w, e) in zip(("state", "y"), pairs))
    err = max(max_err(g, e, dtype, bound) for g, _, e in pairs)
    kern = max(_abs_rel_err(g, e) for g, _, e in pairs)
    if dtype == torch.bfloat16:
        err = max(err, max_err(y, want[0], dtype))
    again = ssm_scan.ssm_scan_cuda(*xs, with_state=True)
    torch.cuda.synchronize()
    assert torch.equal(again[0], y) and torch.equal(again[1], h), \
        "K5 with its state is not deterministic"
    assert torch.equal(ssm_scan.ssm_scan_cuda(*xs), y), \
        "K5's y changed with the state output"
    del want, exact, pairs, again
    ms = time_ms(lambda: ssm_scan.ssm_scan_cuda(*xs, with_state=True),
                 reps=5, inner=5)
    plain_ms = time_events_ms(lambda: ref.ssm_scan_chunked(
        *xs, chunk=ref.SSM_CHUNK), reps=plain_reps) if plain_reps \
        else first_ms
    # x and dt read, y written, B and C read, A and D read, the state
    # written; per (b, t, channel, n) one exponential and 7 float32 ops
    elems = B * S * Din * N
    size = torch.finfo(dtype).bits // 8
    nbytes = (size * 3 * B * S * Din + 4 * 2 * B * S * N
              + 4 * (Din * N + Din) + 4 * B * Din * N)
    bms, by = ssm_bound_ms(nbytes, 7.0 * elems, elems)
    log(f"[{tag} K5+state] {name} {str(dtype)[6:]} B={B} S={S} Din={Din} "
        f"N={N}: "
        f"max_abs_err={err:.3g} (final state"
        f"{' and y' if dtype == torch.float32 else ''} against {against}: "
        f"{kern:.3g} abs+rel, bound {bound:.3g} = max(2e-05, 4 x the float32 "
        f"plain version's {plain:.3g}); {each}"
        + (f"; y tol {TOL[dtype]:g} abs+rel against the plain version"
           if dtype == torch.bfloat16 else "")
        + f") deterministic=True y_unchanged=True ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} library_ms=None bound_ms={bms:.5f} ({by}:"
        f" {nbytes / 1e6:.1f} MB, {elems / 1e6:.1f} M exponentials)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def _k6_state_case(name, dtype, B, H, S, D, DV, gen, tag="36",
                   plain_reps=3) -> dict:
    """K6 with its final state at a prefill's shape against its plain
    version (``ref.mlstm_scan_chunked`` with its state, at the kernel's
    chunk): h, C, n and m in float32 against float64 within max(2e-5, 4x
    the float32 plain version's error), as phase 13; bf16 h, C and n at
    2e-2 abs+rel, m at 2e-5.  ``plain_reps`` 0 times the plain version
    by the check's own call (CUDA events)."""
    chunk = mlstm_scan.kernel_chunk(dtype, D, DV)
    xs, _ = _mlstm_inputs(gen, dtype, B, H, S, D, DV)
    tc0 = mlstm_scan.tc_launches
    h, st = mlstm_scan.mlstm_scan_cuda(*xs, with_state=True)
    path = _path(mlstm_scan.tc_launches - tc0)
    got = (h,) + tuple(st)
    (wh, wst), first_ms = _events_ms(lambda: ref.mlstm_scan_chunked(
        *xs, chunk=chunk, with_state=True))
    want = (wh,) + tuple(wst)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        x64 = tuple(x.double() for x in xs)
        h64, st64 = ref.mlstm_scan_chunked(*x64, chunk=chunk,
                                           with_state=True)
        exact = (h64,) + tuple(st64)
        plain = max(_abs_rel_err(w, e) for w, e in zip(want, exact))
        bound = max(TOL[dtype], 4 * plain)
        err = max(max_err(g, e, dtype, bound) for g, e in zip(got, exact))
        kern = max(_abs_rel_err(g, e) for g, e in zip(got, exact))
        note = (f"h, C, n, m against float64: {kern:.3g} abs+rel (bound "
                f"{bound:.3g} = max(2e-05, 4 x the float32 plain version's "
                f"{plain:.3g}))")
        del x64, exact
    else:
        err = max(max_err(got[0], want[0], dtype),
                  max_err(got[1], want[1], dtype),
                  max_err(got[2], want[2], dtype),
                  max_err(got[3], want[3], dtype, TOL[torch.float32]))
        note = f"tol {TOL[dtype]:g} abs+rel, h, C, n; m at 2e-05"
    again = mlstm_scan.mlstm_scan_cuda(*xs, with_state=True)
    torch.cuda.synchronize()
    assert torch.equal(again[0], h) and all(
        torch.equal(a, b) for a, b in zip(again[1], st)), \
        "K6 with its state is not deterministic"
    assert torch.equal(mlstm_scan.mlstm_scan_cuda(*xs), h), \
        "K6's h changed with the state output"
    del want, again
    ms = time_ms(lambda: mlstm_scan.mlstm_scan_cuda(*xs, with_state=True),
                 reps=5, inner=3)
    plain_ms = time_ms(lambda: ref.mlstm_scan_chunked(
        *xs, chunk=chunk, with_state=True), reps=plain_reps, inner=1) \
        if plain_reps else first_ms
    # as phase 13's forward bound, the final state written instead of the
    # per-row stats
    L, rows = K6_BOUND_CHUNK, B * H * S
    size = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    nbytes = (rows * (size * (2 * D + 2 * DV) + 2 * size)
              + 4 * B * H * (D * DV + D + 1))
    bms, by = bound_ms(nbytes, rows * (2.0 * L * (D + DV) + 4.0 * D * DV),
                       peak)
    log(f"[{tag} K6+state] {name} {str(dtype)[6:]} B={B} H={H} S={S} D={D} "
        f"DV={DV} path={path} chunk={chunk}: max_abs_err={err:.3g} ({note}) "
        f"deterministic=True h_unchanged=True ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms=None bound_ms={bms:.5f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, path=path)


def phase_serve_kernels(gen, hcfg, xcfg, mcfg) -> dict:
    """K5 and K6 with their final state at hymba's and the xLSTM's
    prefill shapes (4 and 8 rows), in both dtypes; K1 at hymba's prefill
    (4 rows of 2080, with its window and global) and K4 at phi3.5-moe's
    serving shapes (a prefill group's capacity buffer, and the decode
    step's and the T = SPEC_K + 1 verify step's: 16 groups of 2 rows a
    slot), in bf16.  Returns the bf16 rows of K5's and K6's state cases,
    K1's windowed prefill and K4's decode case."""
    out = {}
    S = max(HY_SV_PROMPTS)
    for window in (hcfg.sliding_window, 0):
        r = _k1_case(f"hymba prefill window={window}", torch.bfloat16,
                     SV_SLOTS, S, S, hcfg.num_heads, hcfg.num_kv_heads,
                     hcfg.head_dim, window, gen, tag="36 K1")
        out.setdefault("flash_attention", r)
    d_in, N = recurrent.ssm_dims(hcfg)[:2]
    for dtype in (torch.bfloat16, torch.float32):
        r = _k5_state_case("hymba prefill", dtype, SV_SLOTS, S, d_in, N,
                           gen)
        out.setdefault("ssm_scan", r)
        torch.cuda.empty_cache()
    H, D = xcfg.num_heads, 2 * xcfg.d_model // xcfg.num_heads
    for dtype in (torch.bfloat16, torch.float32):
        r = _k6_state_case("xlstm prefill", dtype, 2 * SV_SLOTS, H,
                           max(XL_SV_PROMPTS), D, D, gen)
        out.setdefault("mlstm_scan", r)
        torch.cuda.empty_cache()
    E, Dm, F_ = mcfg.num_experts, mcfg.d_model, mcfg.d_ff
    for step, S in (("prefill", max(MOE_SV_PROMPTS)), ("decode", 1),
                    ("verify", SPEC_K + 1)):
        G = SV_SLOTS * moe.moe_capacity(mcfg, S)
        for what, K, N_ in (("gate/up", Dm, F_), ("down", F_, Dm)):
            r = _k4_case(f"phi3.5 {step} {what} (capacity "
                         f"{moe.moe_capacity(mcfg, S)})", torch.bfloat16,
                         E * G, K, N_, [G] * E, gen, tag="36 K4")
            if step == "decode" and what == "gate/up":
                out["moe_gmm"] = r
        torch.cuda.empty_cache()
    return out


def _reset_serve_counters() -> None:
    """Zero the counters of every kernel a serving path launches."""
    flash_attention.launches = 0
    flash_attention.tc_launches = flash_attention.fma_launches = 0
    _reset_paged_counters(paged_attention, paged_attention_mq)
    moe_gmm.launches = moe_gmm.tc_launches = moe_gmm.fma_launches = 0
    ssm_scan.launches = ssm_scan.state_launches = 0
    mlstm_scan.launches = mlstm_scan.state_launches = 0
    mlstm_scan.tc_launches = mlstm_scan.fma_launches = 0
    _K1_WINDOWED[0] = 0


def _serve_counts() -> dict:
    return {"flash_attention": flash_attention.launches,
            "flash_attention_window": _K1_WINDOWED[0],
            "flash_attention_tc": flash_attention.tc_launches,
            "paged_attention": paged_attention.launches,
            "paged_attention_tc": paged_attention.tc_launches,
            "paged_attention_mq": paged_attention_mq.launches,
            "paged_attention_mq_tc": paged_attention_mq.tc_launches,
            "moe_gmm": moe_gmm.launches, "moe_gmm_tc": moe_gmm.tc_launches,
            "ssm_scan": ssm_scan.launches,
            "ssm_scan_state": ssm_scan.state_launches,
            "mlstm_scan": mlstm_scan.launches,
            "mlstm_scan_state": mlstm_scan.state_launches,
            "mlstm_scan_tc": mlstm_scan.tc_launches}


def _sv_requests(vocab, prompts, news, seed):
    """SV_REQUESTS requests alternating between the two prompt lengths
    (and their budgets)."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, vocab, prompts[i % 2]
                                               ).astype(np.int32),
                    max_new_tokens=news[i % 2])
            for i in range(SV_REQUESTS)]


def _groups(reqs):
    by = {}
    for r in reqs:
        by.setdefault(len(r.prompt), []).append(r)
    return sorted(by.items())


def _direct(model, params, group, max_seq, steps, paged=False, spec_k=0):
    """One admission group run the engine's way, called directly: the
    rows prefilled together (with their extra inputs), then greedy decode
    steps (the dense cache,
    or its paged layout), or greedy speculative rounds on the paged
    layout (n-gram drafts, one verify pass, the longest agreeing prefix
    and the bonus token, ``pos`` rewound), each row cut at its budget.
    Returns each row's tokens and the prefill's and each decode step's
    wall ms (host clock, synchronized)."""
    dev = model.device
    tokens = torch.tensor(np.stack([r.prompt for r in group]),
                          dtype=torch.int32, device=dev)
    extra = {k: torch.from_numpy(np.stack([r.extra[k] for r in group])).to(
        dev) for k in group[0].extra or {}}
    B, S = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens, extra, max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if paged:
        cache = _to_paged(cache, PAGE)
    last = logits.argmax(-1).to(torch.int32)
    out = [[t] for t in last.tolist()]
    step_ms = []
    if not spec_k:
        for _ in range(steps - 1):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, last[:, None])
            last = logits.argmax(-1).to(torch.int32)
            for o, t in zip(out, last.tolist()):
                o.append(t)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return out, prefill_ms, step_ms
    hist = torch.zeros((B, max_seq), dtype=torch.int32, device=dev)
    hist[:, :S] = tokens
    hist[:, S] = last
    zeros = np.zeros(B, np.float32)
    while min(len(o) for o in out) < steps:
        t0 = time.perf_counter()
        pos = cache["pos"]
        drafts = speculate.ngram_propose(hist, pos + 1, k=spec_k, n=3)
        logits, cache = model.verify_step(
            params, cache, torch.cat([last[:, None], drafts], dim=1))
        emitted, m, _ = speculate.accept_and_emit(
            logits, drafts, None, zeros, seed=0, slots=range(B), pos0=pos + 1,
            bonus=True, greedy_only=True)
        left = torch.tensor([steps - len(o) for o in out], dtype=torch.int32,
                            device=dev)
        m = torch.minimum(m, torch.clamp(left, min=0)).to(torch.int32)
        speculate.update_history(hist, pos, emitted, m, left > 0)
        cache = dict(cache, pos=pos + m)
        for o, row, n in zip(out, emitted.tolist(), m.tolist()):
            o += row[:n]
        idx = torch.clamp(m - 1, 0, spec_k).long()
        last = torch.where(m > 0, emitted.gather(1, idx[:, None])[:, 0],
                           last)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return out, prefill_ms, step_ms


def _serve_run(tag, model, params, reqs, max_seq, **kw):
    """The engine over ``reqs``, one burst a prompt length (each group
    admitted whole into the SV_SLOTS slots; counters reset just before,
    read just after), then each group run directly: asserts the tokens
    identical; returns (launches, tokens)."""
    _reset_serve_counters()
    eng = ServeEngine(model, params, max_batch=SV_SLOTS, max_seq=max_seq,
                      eos_id=-1, page_size=PAGE, **kw)
    t0 = time.perf_counter()
    for _, group in _groups(reqs):
        for r in group:
            eng.submit(r)
        eng.run()
    wall = time.perf_counter() - t0
    got = {c.uid: c.tokens for c in eng.done}
    counts = _serve_counts()
    toks = sum(len(v) for v in got.values())
    keys = sorted({eng._group_key(r)[:2] for r in reqs})
    assert keys == [("exact", n) for n, _ in _groups(reqs)], keys
    assert len(got) == len(reqs), got
    paged = kw.get("engine") == "paged"
    if paged:
        assert eng.pool.pages_in_use == 0, "pages leaked after the drain"
    same, prefill, steps = True, [], []
    for n, group in _groups(reqs):
        direct, p_ms, s_ms = _direct(model, params, group, max_seq,
                                     group[0].max_new_tokens, paged=paged,
                                     spec_k=kw.get("spec_k", 0))
        mine = [got[r.uid] for r in group]
        prefill.append(p_ms)
        steps += s_ms
        if mine != direct:
            same = False
            log(f"[{tag}]   group of length {n}: engine {mine} != direct "
                f"{direct}")
    step = statistics.median(steps) if steps else float("nan")
    log(f"[{tag}] {kw}: requests={len(got)} tokens={toks} wall_s={wall:.3f} "
        f"tok_per_s={toks / wall:.1f} (first run, set-up included) "
        f"groups={keys} direct prefill_ms={[round(x, 1) for x in prefill]} "
        f"{'verify round' if kw.get('spec_k') else 'decode step'} ms (host "
        f"clock, synchronized, median)={step:.2f} tokens identical to the "
        f"direct loop: {same} launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    assert same, tag
    return counts, got


def phase_moe_serve(cfg) -> dict:
    """phi3.5-moe at full width, 4 of its 32 layers: 8 requests in two
    exact-length groups on the fused engine, the paged engine and the
    paged engine with spec_k SPEC_K, each run's tokens identical to the
    same groups run directly; K1, K4, K2 and K3 launched, all on the
    tensor cores.  Returns the main path's launches."""
    cut = dataclasses.replace(cfg, num_layers=MOE_SV_LAYERS,
                              name=f"{cfg.name}-{MOE_SV_LAYERS}layer")
    model = build_model(cut)
    t0 = time.perf_counter()
    master = model.init(seed=0)
    params = model.serving_params(master)
    del master
    torch.cuda.synchronize()
    log(f"[37 moe serve] {cut.name}: full width (d_model {cut.d_model}, "
        f"{cut.num_experts} experts top-{cut.top_k}, d_ff {cut.d_ff}), "
        f"{cut.num_layers} of {cfg.num_layers} layers, "
        f"{cut.param_count() / 1e9:.3f} B params, {cut.dtype} serving "
        f"weights (router and gains float32); init "
        f"{time.perf_counter() - t0:.1f} s; capacity a row: prefill "
        f"{[moe.moe_capacity(cut, n) for n in MOE_SV_PROMPTS]}, decode "
        f"{moe.moe_capacity(cut, 1)}, verify "
        f"{moe.moe_capacity(cut, SPEC_K + 1)}")
    reqs = _sv_requests(cut.vocab_size, MOE_SV_PROMPTS, (MOE_SV_NEW,) * 2, 37)
    total = {}
    for kw in (dict(engine="fused"), dict(engine="paged"),
               dict(engine="paged", spec_k=SPEC_K)):
        counts, _ = _serve_run("37 moe serve", model, params, reqs,
                               MOE_SV_MAX_SEQ, **kw)
        assert counts["moe_gmm"] > 0 and counts["moe_gmm_tc"] == counts[
            "moe_gmm"], counts
        assert counts["flash_attention"] == 2 * cut.num_layers, counts
        assert counts["flash_attention_tc"] == counts["flash_attention"]
        if kw["engine"] == "paged":
            key = "paged_attention_mq" if kw.get("spec_k") else \
                "paged_attention"
            assert counts[key] > 0 and counts[key + "_tc"] == counts[key], \
                counts
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    del model, params
    torch.cuda.empty_cache()
    return total


def phase_hymba_serve(cfg) -> dict:
    """hymba-1.5b at full width and depth on the fused engine: a group of
    prompts past the window (the window layers' cache a ring at prefill)
    and one whose decode crosses the window's edge; tokens identical to
    the groups run directly; K1 with and without a window, K5 with its
    state once a layer a group; for one request of each group, the first
    decode steps' logits against the train forward at the same
    positions.  Returns the main path's launches."""
    model = build_model(cfg)
    t0 = time.perf_counter()
    master = model.init(seed=0)
    params = model.serving_params(master)
    torch.cuda.synchronize()
    log(f"[38 hymba serve] {cfg.name}: full width and depth ({cfg.num_layers}"
        f" layers, global {cfg.global_attn_layers}, window "
        f"{cfg.sliding_window}, d_model {cfg.d_model}, SSM d_inner "
        f"{recurrent.ssm_dims(cfg)[0]}), {cfg.param_count() / 1e9:.3f} B "
        f"params; init {time.perf_counter() - t0:.1f} s")
    reqs = _sv_requests(cfg.vocab_size, HY_SV_PROMPTS, HY_SV_NEW, 38)
    with mock.patch.object(ops, "flash_attention", _window_counting):
        counts, got = _serve_run("38 hymba serve", model, params, reqs,
                                 HY_SV_MAX_SEQ, engine="fused")
    n_global = len(cfg.global_attn_layers)
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_attention_window": 2 * (cfg.num_layers - n_global),
            "ssm_scan": 2 * cfg.num_layers,
            "ssm_scan_state": 2 * cfg.num_layers}
    assert {k: counts[k] for k in want} == want, counts
    assert counts["flash_attention_tc"] == counts["flash_attention"], counts
    log(f"[38 hymba serve]   K1 launches with the window "
        f"{cfg.sliding_window}: {counts['flash_attention_window']}, global: "
        f"{counts['flash_attention'] - counts['flash_attention_window']}; K5 "
        f"with its state: {counts['ssm_scan_state']} (one a layer a group)")
    # the decode path against the train forward, one request a group, in
    # the served bf16 and in float32 compute on the same weights
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    worst = {}
    for m, p in ((model, params), (f32, f32.serving_params(master))):
        for n, group in _groups(reqs):
            r = group[0]
            seq = np.concatenate([r.prompt, got[r.uid][:HY_SV_FWD_STEPS]])
            rel = _decode_vs_forward(m, p, seq, n)
            bound = HY_SV_FWD_BOUND[m.cfg.dtype]
            log(f"[38 hymba serve]   {m.cfg.dtype} uid {r.uid} (prompt {n}):"
                f" prefill and decode logits at positions {n - 1}.."
                f"{n - 1 + HY_SV_FWD_STEPS} against the train forward: "
                f"max|diff|/max|logit| = {[round(x, 6) for x in rel]} "
                f"(bound {bound:g})")
            worst[m.cfg.dtype, n] = max(rel)
    assert all(v <= HY_SV_FWD_BOUND[d] for (d, _), v in worst.items()), worst
    del f32, master
    del model, params
    torch.cuda.empty_cache()
    return counts


def _decode_vs_forward(model, params, seq, n) -> list:
    """max |decode - forward| / max |forward logit| at each position n - 1
    .. len(seq) - 2: the prefill of ``seq[:n]`` and decode steps
    teacher-forced on ``seq``, against ``forward_train`` of ``seq``."""
    tokens = torch.tensor(seq[None], dtype=torch.int32, device=model.device)
    logits, cache = model.prefill(params, tokens[:, :n],
                                  max_seq=HY_SV_MAX_SEQ)
    dec = [logits[0]]
    for t in range(n, len(seq) - 1):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1])
        dec.append(logits[0])
    full, _ = lm.forward_train(params, model.cfg, tokens)
    fwd = full[0, n - 1:len(seq) - 1].float()
    return [float((d.float() - f).abs().max() / f.abs().max())
            for d, f in zip(dec, fwd)]


_FLASH = ops.flash_attention
_K1_WINDOWED = [0]  # K1's launches with a window, while counted


def _window_counting(q, k, v, *, causal=True, window=0, q_offset=0):
    """``ops.flash_attention`` that also counts the calls with a
    window."""
    _K1_WINDOWED[0] += window > 0
    return _FLASH(q, k, v, causal=causal, window=window, q_offset=q_offset)


def phase_xlstm_serve(cfg) -> dict:
    """xlstm-125m at full width on the fused engine, groups of 512 and
    384 prompt tokens: tokens identical to the groups run directly; K6
    with its state once for each mLSTM layer a group.  Returns the main
    path's launches."""
    model = build_model(cfg)
    params = model.serving_params(model.init(seed=0))
    n_m = cfg.num_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    log(f"[39 xlstm serve] {cfg.name}: full width ({cfg.num_layers} layers: "
        f"{n_m} mLSTM, {cfg.num_layers - n_m} sLSTM; d_model {cfg.d_model}), "
        f"{cfg.param_count() / 1e9:.4f} B params")
    reqs = _sv_requests(cfg.vocab_size, XL_SV_PROMPTS, (XL_SV_NEW,) * 2, 39)
    counts, _ = _serve_run("39 xlstm serve", model, params, reqs,
                           XL_SV_MAX_SEQ, engine="fused")
    assert counts["mlstm_scan"] == counts["mlstm_scan_state"] == 2 * n_m, \
        counts
    assert counts["mlstm_scan_tc"] == counts["mlstm_scan"], counts
    del model, params
    torch.cuda.empty_cache()
    return counts


def phase_hymba_template(runs: str) -> dict:
    """A serve template for hymba-1.5b, registered as a user registers
    one, at ``scale="full"`` through ``run_workflow`` on the card: its
    completions identical to ``smoke_serve`` called directly on the same
    weights (its 8-token prompts under the window: the ring's empty slots
    masked).  Returns K1's and K5's launches."""
    from repro_torch.core import WorkflowRegistry, WorkflowTemplate

    reg = WorkflowRegistry()
    reg.register(WorkflowTemplate(
        name="serve-hymba-1.5b", version="1.0.0",
        description="Batched serving recipe for hymba-1.5b",
        arch="hymba-1.5b", shape="decode_32k", kind="serve",
        checks=("throughput_positive",)))
    t = reg.get("serve-hymba-1.5b").with_overrides(scale="full")
    cfg = get_config(t.arch)
    _reset_serve_counters()
    res = run_workflow(t, ProvenanceStore(runs), device="cuda",
                       smoke_batch=WF_SMOKE_BATCH)
    counts = _serve_counts()
    done = {c.uid: c.tokens for c in res.final_state}
    assert res.ok and all(ok for ok, _ in res.checks.values()), res.checks
    model = build_model(cfg)
    params = model.serving_params(model.init(t.data.seed))
    direct, _ = smoke_serve(
        model, params, num_requests=2 * WF_SMOKE_BATCH,
        max_batch=WF_SMOKE_BATCH, max_seq=WF_SMOKE_SEQ + 64,
        vocab_size=cfg.vocab_size, seed=t.data.seed)
    del model, params
    torch.cuda.empty_cache()
    same = done == {c.uid: c.tokens for c in direct}
    stats = [r for r in res.record.metrics() if r.get("stage") == "serve"][0]
    log(f"[40 hymba template] {t.name} scale=full ({cfg.num_layers} layers) "
        f"fused: requests={len(done)} tokens={int(stats['tokens'])} "
        f"tok_per_s={stats['tok_per_s']:.1f} launches="
        f"{ {k: v for k, v in counts.items() if v} }; checks {res.checks}; "
        f"stage walls s {_stage_walls(res)}")
    log(f"[40 hymba template]   completions "
        f"{ {u: v[:8] for u, v in sorted(done.items())} }; token-identical "
        f"to smoke_serve called directly: {same}")
    assert len(done) == 2 * WF_SMOKE_BATCH and same, (done, direct)
    assert counts["ssm_scan_state"] == counts["ssm_scan"] > 0, counts
    return counts



# ---------------------------------------------------------------------------
# parallelism and elasticity on an NCCL world of one (phases 41-44)
def _k4_counts() -> dict:
    return {"moe_gmm": moe_gmm.launches, "tc": moe_gmm.tc_launches,
            "fma": moe_gmm.fma_launches}


def _reset_k4_counters() -> None:
    moe_gmm.launches = moe_gmm.tc_launches = moe_gmm.fma_launches = 0


def _k1_tc_only() -> dict:
    """K1's and K1-bwd's launches by path since the counters were reset,
    asserted all on the tensor cores (bf16 at qwen2's head dim)."""
    paths = {f"{m.__name__.rsplit('.', 1)[1]}_{p}": getattr(m, f"{p}_launches")
             for m in (flash_attention, flash_attention_bwd)
             for p in ("tc", "fma")}
    assert paths["flash_attention_fma"] == paths[
        "flash_attention_bwd_fma"] == 0, paths
    return paths


def _card_plan(cfg):
    """The runtime plan of qwen2-1.5b's one-card choice at train_4k's
    global batch cut to 2 (``to_runtime_plan`` of the ``h100-1`` choice,
    the card registered for the call)."""
    register_card()
    try:
        shape = derived_shape("train_4k", TRAIN_BATCH)
        (choice,) = plan(ResourceIntent(arch=cfg.name, shape=shape,
                                        chip_generation="h100",
                                        max_chips=1), top_k=1)
    finally:
        unregister_card()
    assert choice.slice.name == "h100-1", choice.summary
    return choice, to_runtime_plan(choice, cfg=cfg)


def _host_params(state) -> dict:
    return {k: v.detach().to("cpu") for k, v in flatten(state["params"])}


def _nccl_ms(prof) -> tuple:
    """Device ms and count of the NCCL kernels of a profiled run."""
    ms, n = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "nccl" in e.name.lower():
            ms += e.time_range.elapsed_us() / 1e3
            n += 1
    return ms, n


def phase_mesh_train(cfg):
    """41: the sharded train step (``make_train_artifacts`` on
    ``local_mesh()``: an NCCL world of one) at full width and depth,
    against the unsharded step from the same init, bit for bit (both
    with deterministic algorithms on)."""
    choice, rt = _card_plan(cfg)
    assert rt.fsdp and rt.remat == "full", rt
    t0 = time.perf_counter()
    mesh = local_mesh()
    assert dist.get_backend() == "nccl", dist.get_backend()
    init_s = time.perf_counter() - t0
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    stream = make_stream(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    log(f"[41 mesh train] {cfg.name} full width, {cfg.num_layers} layers, "
        f"seq {TRAIN_SEQ}, batch {TRAIN_BATCH}: plan {rt.name} from "
        f"{choice.summary!r} (fsdp={rt.fsdp}, remat={rt.remat}, "
        f"microbatch={rt.microbatch}, attn_impl={rt.attn_impl}: K1) on "
        f"{mesh} (NCCL world of {dist.get_world_size()}, started in "
        f"{init_s:.2f} s)")

    runs = {}
    # the embedding's gradient (an index_add) is bit-exact only with
    # deterministic algorithms, as phase 12's resume
    torch.use_deterministic_algorithms(True)
    for name in ("unsharded", "sharded"):
        state = init_train_state(model, 0, opt, rt)
        if name == "unsharded":
            step = make_train_step(model, opt, rt)
        else:
            art = make_train_artifacts(model, mesh, rt, opt, shape)
            local = shard_tree(state, art.state_shardings)
            assert all(a is b for a, b in zip(leaves(local),
                                              leaves(state))), \
                "a mesh of one copied a leaf"
            state, step = local, art.step_fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_k1_counters()
        state, losses, walls = _unsynced_steps(step, state, batches)
        runs[name] = dict(
            losses=losses, walls=walls, steady=statistics.median(walls[1:]),
            peak=torch.cuda.max_memory_allocated() / 1e9,
            launches={"flash_attention": flash_attention.launches,
                      "flash_attention_bwd": flash_attention_bwd.launches},
            paths=_k1_tc_only(),
            params=_host_params(state))
        if name == "sharded":
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                state, metrics = step(state, batches[TRAIN_STEPS])
                float(metrics["loss"])
            split, _ = _device_split(prof)
            nccl_ms, nccl_n = _nccl_ms(prof)
        del state, step
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    a, b = runs["unsharded"], runs["sharded"]
    same_leaves = all(torch.equal(a["params"][k], b["params"][k])
                      for k in a["params"])
    want = cfg.num_layers * TRAIN_STEPS
    log(f"[41 mesh train] unsharded losses={a['losses']} sharded "
        f"losses={b['losses']}: bit for bit {a['losses'] == b['losses']}; "
        f"every parameter leaf bit for bit: {same_leaves} "
        f"({len(a['params'])} leaves)")
    log(f"[41 mesh train] median step (2-{TRAIN_STEPS}) sharded "
        f"{b['steady']:.4f} s vs unsharded {a['steady']:.4f} s "
        f"({b['steady'] / a['steady'] - 1:+.2%}); step_wall_s sharded "
        f"{[round(x, 4) for x in b['walls']]} unsharded "
        f"{[round(x, 4) for x in a['walls']]}; max_memory_allocated_GB "
        f"sharded {b['peak']:.3f} vs unsharded {a['peak']:.3f}; launches "
        f"{b['launches']} (unsharded {a['launches']}; K1 twice a layer a "
        f"step at remat full, K1-bwd once) paths={b['paths']}; one profiled "
        f"sharded step: NCCL kernels {nccl_n}, {nccl_ms:.4f} ms of "
        f"{sum(split.values()):.1f} ms device time; no host-device sync "
        f"inside steps 2-{TRAIN_STEPS}; deterministic algorithms on")
    assert a["losses"] == b["losses"] and same_leaves, (a["losses"],
                                                        b["losses"])
    assert b["launches"] == a["launches"] == {
        "flash_attention": 2 * want, "flash_attention_bwd": want}, b
    del runs
    return mesh, rt, {k: a["launches"][k] + b["launches"][k]
                      for k in a["launches"]}, b


def phase_mesh_compress(cfg, mesh, rt, base) -> dict:
    """42: phase 41's sharded run with ``compress_grads``: the first loss
    bit for bit the uncompressed one's, ``grad_err`` non-zero after step
    1, the step's overhead and peak beside phase 41's."""
    plan_c = rt.with_(compress_grads=True)
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    stream = make_stream(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    art = make_train_artifacts(model, mesh, plan_c, opt, shape)
    state = shard_tree(init_train_state(model, 0, opt, plan_c),
                       art.state_shardings)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_k1_counters()
    t0 = time.perf_counter()
    state, metrics = art.step_fn(state, batches[0])
    losses = [float(metrics["loss"])]
    walls = [time.perf_counter() - t0]
    first = losses[0]
    err_max = max(float(e.abs().max()) for e in leaves(state["grad_err"]))
    syncs = []
    for i in range(1, TRAIN_STEPS):  # as _unsynced_steps' steps 2-4
        t0 = time.perf_counter()
        (state, metrics), sites = _sync_sites(
            lambda s=state, b=batches[i]: art.step_fn(s, b))
        syncs += sites
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    assert not syncs, f"the compressed step waited for the card at {syncs}"
    steady = statistics.median(walls[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    log(f"[42 mesh compress] compress_grads: first loss {first!r} vs "
        f"phase 41's {base['losses'][0]!r} (bit for bit: "
        f"{first == base['losses'][0]}); max |grad_err| after step 1 "
        f"{err_max:.3e}; losses {losses}; median step "
        f"{steady:.4f} s vs {base['steady']:.4f} s uncompressed "
        f"({steady / base['steady'] - 1:+.2%}); max_memory_allocated_GB "
        f"{peak:.3f} vs {base['peak']:.3f} "
        f"({peak - base['peak']:+.3f} GB; predicted +6.2: grad_err); "
        f"no host-device sync inside steps 2-{TRAIN_STEPS}")
    assert first == base["losses"][0] and err_max > 0
    assert all(np.isfinite(losses))
    del state, art
    torch.cuda.empty_cache()
    return launches


def _grads_of(model, plan_, mesh, batch):
    fn = make_grad_fn(model, plan_, mesh)
    params = model.init(seed=0)
    loss, metrics, grads = fn(params, batch)
    out = (float(loss), float(metrics["aux"]),
           [g.detach() for g in grads])
    del params
    return out


def phase_mesh_moe(mcfg, mesh) -> dict:
    """43: the expert-parallel MoE (``moe_impl="shard_map"``) on the mesh
    of one at full width, 2 of 32 layers, seq 4096, batch 2: at capacity
    factor 8 the loss, aux and every gradient leaf against the scatter
    path's (no token dropped by either), K4 counted; at the config's
    factor the dropped share of each."""
    cfg8 = dataclasses.replace(_moe_cut(mcfg), moe_capacity_factor=8.0)
    model = build_model(cfg8)
    stream = make_stream(cfg8, ShapeConfig("t", MOE_SEQ, MOE_BATCH, "train"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch_at(0).items()}
    names = [k for k, _ in flatten(model.param_specs()[0])]
    _reset_k4_counters()
    t0 = time.perf_counter()
    scat = _grads_of(model, Plan(remat="full"), None, batch)
    k4_scatter = _k4_counts()
    _reset_k4_counters()
    t1 = time.perf_counter()
    ep = _grads_of(model, Plan(remat="full", moe_impl="shard_map"), mesh,
                   batch)
    t2 = time.perf_counter()
    k4_ep = _k4_counts()
    rel_loss = abs(ep[0] - scat[0]) / abs(scat[0])
    rel_aux = abs(ep[1] - scat[1]) / abs(scat[1])
    leaf_err = {n: float((g - w).abs().max() / w.abs().max())
                for n, g, w in zip(names, ep[2], scat[2])}
    worst = max(leaf_err, key=leaf_err.get)
    want = 9 * cfg8.num_layers  # 3 forward, 3 recomputed, 3 dX a layer
    log(f"[43 mesh moe] {cfg8.name} capacity factor 8, remat full: "
        f"shard_map loss {ep[0]!r} aux {ep[1]!r} vs scatter {scat[0]!r} "
        f"{scat[1]!r} (rel {rel_loss:.3g} and {rel_aux:.3g}, bound "
        f"{LOSS_REL_BOUND}); worst gradient leaf {worst} "
        f"{leaf_err[worst]:.3g} of its max (bound "
        f"{GRAD_TOL[torch.bfloat16]}); K4 launches shard_map {k4_ep} "
        f"scatter {k4_scatter} (want {want}: {cfg8.num_layers} layers x 3 "
        f"forward, 3 recomputed, 3 dX); {t1 - t0:.1f} s vs {t2 - t1:.1f} s")
    assert rel_loss <= LOSS_REL_BOUND and rel_aux <= LOSS_REL_BOUND
    assert leaf_err[worst] <= GRAD_TOL[torch.bfloat16], leaf_err
    assert k4_ep == k4_scatter == {"moe_gmm": want, "tc": want, "fma": 0}
    del scat, ep, model
    torch.cuda.empty_cache()

    cut = _moe_cut(mcfg)
    model = build_model(cut)
    params = model.init(seed=0)
    shares = {}
    for impl in ("scatter", "shard_map"):
        moe.drop_stats = []
        try:
            with torch.no_grad(), moe.moe_impl(impl, mesh):
                model.loss(params, batch, remat="none")
            kept = sum(int(k) for k, _ in moe.drop_stats)
            total = sum(n for _, n in moe.drop_stats)
        finally:
            moe.drop_stats = None
        shares[impl] = 1 - kept / total
    log(f"[43 mesh moe] at the config's capacity factor "
        f"{cut.moe_capacity_factor}: dropped share of the (token, k) "
        f"entries, 2 layers: scatter {shares['scatter']:.4%} (groups of one "
        f"row, capacity {moe.moe_capacity(cut, MOE_SEQ)}), shard_map "
        f"{shares['shard_map']:.4%} (one group of {MOE_BATCH * MOE_SEQ} "
        f"tokens, capacity "
        f"{moe.shardmap_capacity(cut, MOE_BATCH * MOE_SEQ)})")
    del params, model
    torch.cuda.empty_cache()
    return {"moe_gmm": k4_ep["moe_gmm"]}


def phase_elastic(cfg, rt) -> dict:
    """44: elastic restore at full width, depth cut to 4 of 28 layers:
    phase 41's sharded step, a save through the layouts, then
    ``elastic_restart`` onto the mesh of ``Placement(h100-8, (8, 1))``
    folded to the card; every leaf bit for bit, the next step bit for bit
    the uninterrupted one's (deterministic algorithms on); then a
    ``train-qwen2-1.5b`` run cut at step 3 and resumed through
    ``run_workflow`` logs ``reshard``."""
    cut = dataclasses.replace(cfg, num_layers=4, name=cfg.name + "-4layer")
    model = build_model(cut)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    stream = make_stream(cut, shape)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()} for i in range(2)]
    mesh = local_mesh()
    art = make_train_artifacts(model, mesh, rt, opt, shape)
    lay = art.state_shardings
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}

    def count(fn):
        _reset_k1_counters()
        out = fn()
        launches["flash_attention"] += flash_attention.launches
        launches["flash_attention_bwd"] += flash_attention_bwd.launches
        return out

    torch.use_deterministic_algorithms(True)
    try:
        state = shard_tree(init_train_state(model, 0, opt, rt), lay)
        state, _ = count(lambda: art.step_fn(state, batches[0]))
        saved = {k: v.detach().clone() for k, v in flatten(state)}
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, keep=1)
            t0 = time.perf_counter()
            ck.save(0, state, shardings=lay, blocking=True)
            save_s = time.perf_counter() - t0
            nbytes = _tree_gb(d)
            whole, _ = count(lambda: art.step_fn(state, batches[1]))
            whole = {k: v.detach().clone() for k, v in flatten(whole)}
            del state
            placement = Placement(stage="train", slice_name="h100-8",
                                  mesh_shape=(8, 1),
                                  mesh_axes=("data", "model"), chips=8,
                                  price_per_hour=0.0)
            new_mesh = placement.build_mesh()
            like = init_train_state(model, 1, opt, rt)  # another seed
            t0 = time.perf_counter()
            restored, step = elastic_restart(ck, like, model, new_mesh, rt)
            restore_s = time.perf_counter() - t0
            del like
        same = all(torch.equal(v, saved[k]) for k, v in flatten(restored))
        step_fn = make_train_step(model, opt, rt, new_mesh)
        after, _ = count(lambda: step_fn(restored, batches[1]))
        next_same = all(torch.equal(v, whole[k]) for k, v in flatten(after))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[44 elastic] {cut.name} seq {TRAIN_SEQ} batch {TRAIN_BATCH}: "
        f"saved step {step} through {mesh}'s layouts ({nbytes:.2f} GB in "
        f"{save_s:.1f} s), restored onto {placement.slice_name} "
        f"{placement.mesh_shape} folded to {new_mesh} in {restore_s:.1f} s; "
        f"every leaf bit for bit: {same} ({len(saved)} leaves); the next "
        f"step bit for bit the uninterrupted one's: {next_same}")
    assert step == 0 and same and next_same
    del restored, after, saved, whole, model
    torch.cuda.empty_cache()

    t = REGISTRY.get("train-qwen2-1.5b").with_overrides(checkpoint_every=2)
    with tempfile.TemporaryDirectory() as runs:
        store = ProvenanceStore(runs)
        try:
            _train_workflow(t, runs, failures=_Cut((3,)))
            raise AssertionError("the cut run did not stop")
        except RuntimeError as e:
            assert "cut at step 3" in str(e), e
        (cut_id,) = store.list_runs()
        saved_step = _committed(runs, cut_id)
        resumed = count(lambda: _train_workflow(t, runs, resume=cut_id))
        kinds = [e for e in resumed.record.events()
                 if e["kind"].startswith("reshard")]
    log(f"[44 elastic] {t.name} cut at step 3 (step {saved_step} "
        f"committed) and resumed through run_workflow: ok={resumed.ok}, "
        f"events {kinds}")
    assert resumed.ok and [e["kind"] for e in kinds] == ["reshard"], kinds
    return launches


def phase_mesh_split(cfg, mesh, rt, base) -> dict:
    """45: phase 41's sharded run with the split over ``model`` installed
    by heads (``rt``) and by the sequence (``seq_shard_attn``): each run's
    losses and every leaf bit for bit phase 41's (its unsharded and
    sharded runs agree bit for bit), the peak within 0.05 GB of it, steps
    2-4 synced nowhere, K1 and K1-bwd all on the tensor cores.  Every
    split the step installs is recorded (a world of one splits nothing:
    the split functions run the unsplit code)."""
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    stream = make_stream(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    installed = []
    install = tensor.split

    @contextlib.contextmanager
    def recorded(sp):
        installed.append(None if sp is None else (sp.attn, sp.size))
        with install(sp):
            yield

    total = {"flash_attention": 0, "flash_attention_bwd": 0}
    tensor.split = recorded
    torch.use_deterministic_algorithms(True)
    try:
        for mode, seq in (("heads", False), ("seq", True)):
            plan_ = rt.with_(seq_shard_attn=seq)
            art = make_train_artifacts(model, mesh, plan_, opt, shape)
            state = shard_tree(init_train_state(model, 0, opt, plan_),
                               art.state_shardings)
            installed.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_k1_counters()
            state, losses, walls = _unsynced_steps(art.step_fn, state,
                                                   batches)
            peak = torch.cuda.max_memory_allocated() / 1e9
            paths = _k1_tc_only()
            launches = {"flash_attention": flash_attention.launches,
                        "flash_attention_bwd": flash_attention_bwd.launches}
            params = _host_params(state)
            same = all(torch.equal(params[k], base["params"][k])
                       for k in base["params"])
            steady = statistics.median(walls[1:])
            log(f"[45 mesh split] attention split by {mode} "
                f"(seq_shard_attn={seq}), splits installed "
                f"{sorted(set(installed))} ({len(installed)} steps, model "
                f"axis of {mesh.size('model')}): losses {losses} vs phase "
                f"41's {base['losses']}: bit for bit "
                f"{losses == base['losses']}; every parameter leaf bit for "
                f"bit: {same} ({len(params)} leaves); median step "
                f"{steady:.4f} s vs {base['steady']:.4f} s "
                f"({steady / base['steady'] - 1:+.2%}); "
                f"max_memory_allocated_GB {peak:.3f} vs {base['peak']:.3f} "
                f"({peak - base['peak']:+.3f}); launches {launches} "
                f"paths={paths}; no host-device sync inside steps "
                f"2-{TRAIN_STEPS}; deterministic algorithms on")
            assert installed and set(installed) == {(mode, 1)}, installed
            assert losses == base["losses"] and same, (losses,
                                                       base["losses"])
            assert abs(peak - base["peak"]) <= 0.05, (peak, base["peak"])
            assert launches == base["launches"], (launches, base)
            for k in total:
                total[k] += launches[k]
            del state, art, params
            torch.cuda.empty_cache()
    finally:
        tensor.split = install
        torch.use_deterministic_algorithms(False)
    return total


# the split's per-rank attention shapes (B, S, T, H, KH, D, q_offset):
# internlm2-20b's rank of a (2, 4) mesh (48 heads over 8 KV heads, 12 and
# 2 a rank), qwen2-1.5b's context-parallel ranks under a model axis of 8
# (12 % 8 != 0: the planner sets seq_shard_attn; 4096 / 8 = 512 rows)
TP_K1_CASES = (
    ("internlm2-20b (2, 4) rank: 12 of 48 heads", 2, 4096, 4096, 12, 2,
     128, 0),
    ("qwen2-1.5b seq rank 0 of 8", 2, 512, 4096, 12, 2, 128, 0),
    ("qwen2-1.5b seq rank 4 of 8", 2, 512, 4096, 12, 2, 128, 2048),
    ("qwen2-1.5b seq rank 7 of 8", 2, 512, 4096, 12, 2, 128, 3584))


def phase_tp_kernels(gen, full_bwd, full_fwd) -> list:
    """46: K1 with its LSE and K1-bwd at the split's per-rank shapes
    (``TP_K1_CASES``) in bf16 against their plain versions, with their
    times beside phase 9's full-sequence K1 and K1-bwd (B 2, S = T 4096,
    12 heads); the dK and dV rows past each block's last query exactly
    zero.  Returns ``(K1 row, K1-bwd row)`` a shape."""
    rows = []
    for name, B, S, T, H, KH, D, off in TP_K1_CASES:
        r = _k1_train_case(name, torch.bfloat16, B, S, T, H, KH, D, 0, off,
                           gen, phase=46, unseen_zero=True)
        log(f"[46 K1 split] {name}: K1 {r['fwd']['ms']:.4f} ms "
            f"({r['fwd']['ms'] / full_fwd['ms']:.3f}x phase 9's full "
            f"sequence {full_fwd['ms']:.4f}), K1-bwd {r['ms']:.4f} ms "
            f"({r['ms'] / full_bwd['ms']:.3f}x {full_bwd['ms']:.4f})")
        fwd = r.pop("fwd")
        dims = dict(shape=name, B=B, S=S, T=T, H=H, KH=KH, D=D, q_offset=off)
        rows.append((dict(dims, **fwd), dict(dims, **r)))
        torch.cuda.empty_cache()
    return rows


# phase 48: the three families the split now covers, 2 layers each
FAMILY_ARCHS = ("phi-3-vision-4.2b", "whisper-large-v3", "hymba-1.5b")
FAMILY_LAYERS, FAMILY_BATCH, FAMILY_STEPS = 2, 1, 2
FAMILY_COUNTERS = {"flash_attention": (flash_attention, "launches"),
                   "flash_attention_bwd": (flash_attention_bwd, "launches"),
                   "ssm_scan": (ssm_scan, "launches"),
                   "ssm_scan_bwd": (ssm_scan, "bwd_launches")}


def _family_cut(arch: str):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=FAMILY_LAYERS, encoder_layers=(
        FAMILY_LAYERS if cfg.is_encoder_decoder else 0))


def phase_mesh_families(mesh, rt, gen) -> dict:
    """48: phi-3-vision, whisper and hymba at full width, 2 layers, seq
    4096, batch 1, remat full: the sharded step on phase 41's NCCL world
    of one against the unsharded step from the same init, two steps,
    every loss and leaf bit for bit and the peak within 0.05 GB; then K5
    and K5-bwd at hymba's rank of a ``model`` axis of 4, and K1 and K1-bwd
    on whisper's encoder at a sequence-split rank.  Returns the kernels'
    launches in the runs (the main path's) and the timed rows."""
    total = {k: 0 for k in FAMILY_COUNTERS}
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, FAMILY_BATCH, "train")
    opt = OptimizerConfig(lr=PV_LR, warmup_steps=2, total_steps=100)
    torch.use_deterministic_algorithms(True)
    try:
        for arch in FAMILY_ARCHS:
            cfg = _family_cut(arch)
            model = build_model(cfg)
            stream = make_stream(cfg, shape)
            batches = [{k: torch.from_numpy(v).cuda()
                        for k, v in stream.batch_at(i).items()}
                       for i in range(FAMILY_STEPS)]
            runs = {}
            for name in ("unsharded", "sharded"):
                state = init_train_state(model, 0, opt, rt)
                if name == "unsharded":
                    step = make_train_step(model, opt, rt)
                else:
                    art = make_train_artifacts(model, mesh, rt, opt, shape)
                    state = shard_tree(state, art.state_shardings)
                    step = art.step_fn
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for mod, attr in FAMILY_COUNTERS.values():
                    setattr(mod, attr, 0)
                losses, t0 = [], time.perf_counter()
                for b in batches:
                    state, metrics = step(state, b)
                    losses.append(float(metrics["loss"]))
                runs[name] = dict(
                    losses=losses, wall=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated() / 1e9,
                    launches={k: getattr(mod, attr) for k, (mod, attr)
                              in FAMILY_COUNTERS.items()},
                    params=_host_params(state))
                del state, step
                torch.cuda.empty_cache()
            a, b = runs["unsharded"], runs["sharded"]
            same = all(torch.equal(a["params"][k], b["params"][k])
                       for k in a["params"])
            log(f"[48 mesh families] {cfg.name} full width, "
                f"{cfg.num_layers} layers"
                + (f" (+{cfg.encoder_layers} encoder)"
                   if cfg.is_encoder_decoder else "")
                + f", seq {TRAIN_SEQ}, batch {FAMILY_BATCH}, remat "
                f"{rt.remat}: unsharded losses={a['losses']} sharded "
                f"losses={b['losses']}: bit for bit "
                f"{a['losses'] == b['losses']}; every parameter leaf bit "
                f"for bit: {same} ({len(a['params'])} leaves); "
                f"max_memory_allocated_GB sharded {b['peak']:.3f} vs "
                f"unsharded {a['peak']:.3f}; {FAMILY_STEPS} steps "
                f"{b['wall']:.3f} s vs {a['wall']:.3f} s; launches "
                f"{b['launches']} (unsharded {a['launches']})")
            assert a["losses"] == b["losses"] and same, (a["losses"],
                                                         b["losses"])
            assert abs(a["peak"] - b["peak"]) <= 0.05, (a["peak"], b["peak"])
            assert a["launches"] == b["launches"], (a, b)
            assert b["launches"]["flash_attention_bwd"] > 0
            for k in total:
                total[k] += a["launches"][k] + b["launches"][k]
            del runs, a, b, model, batches
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    assert total["ssm_scan"] > 0 and total["ssm_scan_bwd"] > 0, total
    hcfg = get_config("hymba-1.5b")
    d_in, N = recurrent.ssm_dims(hcfg)[:2]
    k5, k5_bwd = _k5_case(f"hymba rank of model 4 ({d_in // 4} of {d_in} "
                          f"channels)", torch.bfloat16, FAMILY_BATCH,
                          TRAIN_SEQ, d_in // 4, N, gen, phase=48)
    wcfg = get_config("whisper-large-v3")
    T = wcfg.encoder_frames
    r = _k1_train_case(
        f"whisper encoder seq rank 1 of 4 ({T // 4} of {T} frames)",
        torch.bfloat16, FAMILY_BATCH, T // 4, T, wcfg.num_heads,
        wcfg.num_kv_heads, wcfg.head_dim, 0, T // 4, gen, phase=48,
        causal=False)
    k1 = r.pop("fwd")
    torch.cuda.empty_cache()
    return {"launches": total,
            "K1": dict(k1, shape=f"whisper encoder seq rank, B 1, S "
                       f"{T // 4}, T {T}, non-causal, q_offset {T // 4}"),
            "K1-bwd": dict(r, shape="the same"),
            "K5": dict(k5, shape=f"hymba rank of model 4, B 1, S "
                       f"{TRAIN_SEQ}, Din {d_in // 4}, N {N}"),
            "K5-bwd": dict(k5_bwd, shape="the same")}


DRYRUN_CODE = r"""
import dataclasses, json, sys, time
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.cells import analyze_cell, build_cell
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.parallel.sharding import Plan
args = json.loads(sys.argv[1])
plan = Plan(**{k: tuple(v) if isinstance(v, list) else v
               for k, v in args["plan"].items()})
fake_world(1)
mesh = make_mesh((1, 1), device="cpu")
cell = build_cell("qwen2-1.5b", "train_4k", mesh, plan,
                  shape=ShapeConfig("train_4k-cut", args["seq"],
                                    args["batch"], "train"))
t0 = time.time()
one = analyze_cell(cell)
one["wall_s"] = time.time() - t0
t0 = time.time()
prod = analyze_cell(build_cell("qwen2-1.5b", "train_4k",
                               make_production_mesh()))
prod["wall_s"] = time.time() - t0
import torch
print(json.dumps({"one": one, "prod": prod,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def phase_dryrun(cfg) -> None:
    """47: the dry-run of phase 41's cell in a subprocess that sees no
    card, against that step counted on the card."""
    from repro_torch.launch.op_stats import OpCounter, roofline_terms

    choice, rt = _card_plan(cfg)
    t0 = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    arg = json.dumps({"plan": dataclasses.asdict(rt), "seq": TRAIN_SEQ,
                      "batch": TRAIN_BATCH})
    r = subprocess.run([sys.executable, "-c", DRYRUN_CODE, arg], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    sub_s = time.perf_counter() - t0
    assert not out["cuda_initialized"], "the dry-run touched CUDA"
    dry, prod = out["one"], out["prod"]
    log(f"[47 dry-run] {cfg.name} seq {TRAIN_SEQ} batch {TRAIN_BATCH} "
        f"remat {rt.remat} plan {rt.name} on a (1, 1) mesh over a fake "
        f"world of one (subprocess, no CUDA, {sub_s:.1f} s with the 16x16 "
        f"cell): flops {dry['flops']:.6e}, hbm_bytes "
        f"{dry['bytes_accessed']:.6e}, arguments "
        f"{dry['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
        f"{dry['temp_size_in_bytes'] / 1e9:.3f} GB, kernels "
        f"{ {k: v['calls'] for k, v in dry['hlo_stats']['kernels'].items()} }, "
        f"collectives {dry['collectives']['total_ops']}; the step's wall "
        f"time on fake tensors {dry['wall_s']:.1f} s")
    pc = prod["collectives"]
    log(f"[47 dry-run] {cfg.name} train_4k on the 16x16 mesh over a fake "
        f"world of 256: wall {prod['wall_s']:.1f} s, per rank flops "
        f"{prod['flops']:.6e}, arguments "
        f"{prod['argument_size_in_bytes'] / 1e9:.3f} GB + temp "
        f"{prod['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
        f"{pc['total_operand_bytes'] / 1e9:.3f} GB in {pc['total_ops']} ops "
        f"{ {k: round(v / 1e9, 3) for k, v in pc['operand_bytes_by_kind'].items()} }")

    mesh = local_mesh()
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    shape = ShapeConfig("train_4k-cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    stream = make_stream(cfg, shape)
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in stream.batch_at(i).items()} for i in range(5)]
    art = make_train_artifacts(model, mesh, rt, opt, shape)
    state = shard_tree(init_train_state(model, 0, opt, rt),
                       art.state_shardings)
    step = art.step_fn
    state, m = step(state, batches[0])  # warm
    float(m["loss"])
    walls = []
    for b in batches[1:4]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with OpCounter() as counter:
        state, m = step(state, batches[4])
        float(m["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    card = counter.stats()
    del state, step, art, batches
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    rel = abs(card["flops"] - dry["flops"]) / dry["flops"]
    mem = dry["argument_size_in_bytes"] + dry["temp_size_in_bytes"]
    terms = roofline_terms(dry["hlo_stats"], "h100")
    log(f"[47 dry-run] the card's step under the counter: flops "
        f"{card['flops']:.6e} (dry-run {dry['flops']:.6e}, rel diff "
        f"{rel:.2e}), kernels "
        f"{ {k: v['calls'] for k, v in card['kernels'].items()} }, "
        f"collectives {card['total_collective_bytes']}; "
        f"max_memory_allocated over the step {peak / 1e9:.3f} GB vs the "
        f"dry-run's arguments + temp {mem / 1e9:.3f} GB "
        f"({mem / peak - 1:+.2%})")
    log(f"[47 dry-run] H100 roofline terms of the dry-run: compute "
        f"{terms['compute_s'] * 1e3:.2f} ms, memory "
        f"{terms['memory_s'] * 1e3:.2f} ms, collective "
        f"{terms['collective_s'] * 1e3:.2f} ms; measured step (median of "
        f"3) {step_s:.4f} s {[round(w, 4) for w in walls]}: flops / "
        f"(step_s * 989.4e12) = {dry['flops'] / (step_s * 989.4e12):.4f}")
    assert rel <= 1e-6, (card["flops"], dry["flops"])
    assert abs(mem / peak - 1) <= 0.05, (mem, peak)
    assert card["total_collective_bytes"] == 0 and not card["collective_ops"]
    assert dry["collectives"]["total_ops"] == 0, dry["collectives"]


# phase 49: the dense decoders served split over ``model``.  K1 at
# glm4-9b's split prefill rank (prefill_32k on 16x16: 2 rows a data rank,
# 32 heads over 16 = 2 query heads reading 1 of its 2 KV heads), held
# against its plain version at SV_K1_CHECK_S with the same heads; then
# qwen2-1.5b served with its cache read whole and read in SV_BLOCKS blocks
# merged as the ranks of a sequence-split cache merge theirs
SV_K1 = dict(B=2, S=32768, H=2, KH=1, D=128)
SV_K1_CHECK_S = 4096
SV_SLOTS_SPLIT, SV_CACHE, SV_PROMPT, SV_STEPS = 8, 32768, 4096, 16
SV_BLOCKS, SV_F32_LAYERS = 16, 4


def _k1_split_prefill_case(gen, shape=None, tag="49 K1 split prefill",
                           what="glm4-9b") -> dict:
    dev, dt = torch.device("cuda"), torch.bfloat16
    shape = shape or SV_K1
    B, S, H, KH, D = (shape[k] for k in ("B", "S", "H", "KH", "D"))

    def qkv(n):
        return (torch.randn((B, n, h, D), generator=gen, device=dev).to(dt)
                for h in (H, KH, KH))

    q, k, v = qkv(SV_K1_CHECK_S)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention.plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(got, want, dt)
    plain_ms = time_ms(lambda: flash_attention.plain(q, k, v, causal=True),
                       reps=3, inner=1)
    del q, k, v, got, want
    q, k, v = qkv(S)
    ms = time_ms(lambda: flash_attention.flash_attention_cuda(
        q, k, v, causal=True), reps=5, inner=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=5, inner=3)
    pairs = S * (S + 1) // 2
    bms, by = bound_ms(2 * (2 * B * S * H * D + 2 * B * S * KH * D),
                       4.0 * B * H * D * pairs, BF16_FLOPS)
    log(f"[{tag}] {what}'s rank of prefill_32k on 16x16: "
        f"bf16 B={B} S=T={S} H={H} KH={KH} D={D} causal: ms={ms:.4f} "
        f"library_ms={lib_ms:.4f} ms/library_ms={ms / lib_ms:.2f} "
        f"bound_ms={bms:.5f} ({by}); against the plain version at "
        f"S=T={SV_K1_CHECK_S}: max_abs_err={err:.3g} (tol {TOL[dt]:g} "
        f"abs+rel), plain_ms={plain_ms:.4f} (there)")
    return dict(shape=f"{what} prefill_32k 16x16 rank", B=B, S=S, T=S, H=H,
                KH=KH, D=D, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                plain_at_S=SV_K1_CHECK_S, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def _served(model, params, tokens, steps, blocks, forced=None, experts=1,
            extra=None):
    """The prefill (of ``extra`` too: whisper's frames) into a cache of
    SV_CACHE positions, then ``steps`` decode steps reading the cache
    whole (``blocks`` 1) or in ``blocks`` merged blocks, each step fed
    the greedy token (or ``forced``'s); a MoE's experts computed whole
    (``experts`` 1) or as ``experts`` blocks whose partial outputs are
    summed (``moe.expert_blocks``)."""
    with moe.expert_blocks(experts):
        logits, cache = model.prefill(params, tokens, extra,
                                      max_seq=SV_CACHE)
        seen, chosen = [logits.float()], []
        for i in range(steps):
            nxt = (logits.argmax(-1).to(torch.int32)[:, None]
                   if forced is None else forced[:, i:i + 1])
            chosen.append(nxt)
            logits, cache = model.decode_step(params, cache, nxt,
                                              kv_blocks=blocks)
            seen.append(logits.float())
    torch.cuda.synchronize()
    return torch.stack(seen), torch.cat(chosen, 1)


def phase_serve_split(gen) -> dict:
    """49: K1 at glm4-9b's split prefill rank; qwen2-1.5b at full width in
    bf16, 8 slots, a cache of 32768, prompts of 4096, 16 decode steps,
    its cache read whole and read in 16 blocks of 2048 merged by
    ``merge_partials`` (the sequence-split decode's arithmetic on one
    card), fed the same tokens: logits within the kernels' bf16
    tolerance; then the same at 4 layers in float32, each run choosing
    its own greedy tokens: identical.  Returns K1's row and its launches
    in the served runs."""
    t0 = time.perf_counter()
    row = _k1_split_prefill_case(gen)
    torch.cuda.empty_cache()
    n0 = flash_attention.launches
    cfg = get_config("qwen2-1.5b")
    out = {}
    for dt, layers in (("bfloat16", cfg.num_layers),
                       ("float32", SV_F32_LAYERS)):
        c = dataclasses.replace(cfg, dtype=dt, num_layers=layers)
        model = build_model(c)
        params = model.serving_params(model.init(seed=0))
        tokens = torch.randint(0, c.vocab_size, (SV_SLOTS_SPLIT, SV_PROMPT),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        t1 = time.perf_counter()
        whole, toks = _served(model, params, tokens, SV_STEPS, 1)
        t_whole = time.perf_counter() - t1
        t1 = time.perf_counter()
        split, split_toks = _served(
            model, params, tokens, SV_STEPS, SV_BLOCKS,
            forced=toks if dt == "bfloat16" else None)
        t_split = time.perf_counter() - t1
        assert bool(torch.isfinite(split).all()) and split.shape == (
            SV_STEPS + 1, SV_SLOTS_SPLIT, c.vocab_size), split.shape
        rel = float((split - whole).abs().max() / whole.abs().max())
        if dt == "bfloat16":
            err = max_err(split, whole, torch.bfloat16)
            log(f"[49 serve split] {c.name} bf16, {layers} layers, "
                f"{SV_SLOTS_SPLIT} slots, cache {SV_CACHE}, prompt "
                f"{SV_PROMPT}, {SV_STEPS} steps: cache read in {SV_BLOCKS} "
                f"blocks of {SV_CACHE // SV_BLOCKS} merged vs read whole, "
                f"fed the same tokens: max |diff| of the logits {err:.4g} "
                f"(tol {TOL[torch.bfloat16]:g} abs+rel), {rel:.3g} of max "
                f"|logit|; whole {t_whole:.2f} s, blocks {t_split:.2f} s "
                f"(host clock, prefill included)")
        else:
            same = bool(torch.equal(split_toks, toks))
            log(f"[49 serve split] {c.name} float32, {layers} layers: greedy "
                f"tokens of the merged read identical to the whole read's: "
                f"{same} ({toks.numel()} tokens); logits {rel:.3g} of max "
                f"|logit| apart")
            assert same, (split_toks, toks)
        out[dt] = rel
        del model, params, whole, split
        torch.cuda.empty_cache()
    launches = flash_attention.launches - n0
    took = time.perf_counter() - t0
    log(f"[49 serve split] K1 launches in the served runs {launches}; the "
        f"phase took {took:.1f} s")
    return {"K1": row, "flash_attention": launches, "seconds": took}


# phase 50: the MoE decoders and phi-3-vision served split over
# ``model``.  K4 at the local experts of a rank of the 16x16 serving cells
# (D 4096; the gate/up product, K = D, N = d_ff): (name, experts, rows an
# expert, d_ff) — a decode rank holds 8 slots (its capacity rows an
# expert are 8 x the layer's capacity at S 1), a prefill rank 2 rows of
# 32768 (2 x the capacity at S 32768)
SM_K4 = (("qwen3-moe decode rank", 8, 64, 1536),
         ("phi3.5-moe decode rank", 1, 16, 6400),
         ("qwen3-moe prefill rank", 8, 5120, 1536),
         ("phi3.5-moe prefill rank", 1, 10240, 6400))
# K1 at phi-3-vision's prefill_32k rank on 16x16: 2 rows of 32768, 2 of
# its 32 heads of 96 (MHA)
SM_K1 = dict(B=2, S=32768, H=2, KH=2, D=96)
# phi3.5-moe at full width served with its 16 experts computed as 16
# blocks (a rank each on a model axis of 16), against the whole layer: 2
# of its 32 layers, phase 49's slots, cache, prompts and steps.  The
# cache is read whole in both runs (phase 49 holds the blocked read): the
# blocked read rounds the hidden states otherwise in bf16, and routing is
# not continuous in them (a near-tied top-k choice can flip), so the two
# together are no test of the experts' blocks (with both, the bf16 logits
# were 0.70 apart, beyond the tolerance; NVIDIA H100 80GB HBM3, 700 W)
SM_LAYERS, SM_EXPERT_BLOCKS = 2, 16


def phase_serve_split_moe(gen) -> dict:
    """50: K4 at the local-expert shapes of a rank of the MoE serving
    cells (``SM_K4``) and K1 at phi-3-vision's split prefill rank, each
    against its plain version with its time, the library's and its
    bound; then phi3.5-moe at full width, 2 layers, in bf16, served with
    its experts as 16 blocks whose partial outputs are summed (the
    experts' arithmetic of a model axis of 16, on one card), against the
    whole layer, fed the same tokens: logits within ``TOL``'s bf16
    tolerance; the same in float32, each run choosing its own greedy
    tokens: identical.  Returns the kernel rows and the served runs'
    launches."""
    t0 = time.perf_counter()
    rows = []
    for name, e, g, f in SM_K4:
        r = _k4_case(name, torch.bfloat16, e * g, 4096, f, [g] * e, gen,
                     tag="50 K4 split")
        rows.append(dict(r, shape=name, experts=e, rows_per_expert=g, K=4096,
                         N=f))
        torch.cuda.empty_cache()
    k1 = _k1_split_prefill_case(gen, SM_K1, "50 K1 split prefill",
                                "phi-3-vision-4.2b")
    torch.cuda.empty_cache()
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    assert cfg.num_experts % SM_EXPERT_BLOCKS == 0, cfg.num_experts
    n_k4, n_k1 = moe_gmm.launches, flash_attention.launches
    out = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt, num_layers=SM_LAYERS)
        model = build_model(c)
        params = model.serving_params(model.init(seed=0))
        tokens = torch.randint(0, c.vocab_size, (SV_SLOTS_SPLIT, SV_PROMPT),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        t1 = time.perf_counter()
        whole, toks = _served(model, params, tokens, SV_STEPS, 1)
        t_whole = time.perf_counter() - t1
        t1 = time.perf_counter()
        split, split_toks = _served(
            model, params, tokens, SV_STEPS, 1,
            forced=toks if dt == "bfloat16" else None,
            experts=SM_EXPERT_BLOCKS)
        t_split = time.perf_counter() - t1
        assert bool(torch.isfinite(split).all()) and split.shape == (
            SV_STEPS + 1, SV_SLOTS_SPLIT, c.vocab_size), split.shape
        rel = float((split - whole).abs().max() / whole.abs().max())
        if dt == "bfloat16":
            err = max_err(split, whole, torch.bfloat16)
            log(f"[50 serve split moe] {c.name} bf16, {SM_LAYERS} layers, "
                f"{c.num_experts} experts top-{c.top_k}, {SV_SLOTS_SPLIT} "
                f"slots, cache {SV_CACHE}, prompt {SV_PROMPT}, {SV_STEPS} "
                f"steps: experts in {SM_EXPERT_BLOCKS} blocks summed vs the "
                f"whole layer, fed the same tokens: max |diff| of the "
                f"logits {err:.4g} (tol {TOL[torch.bfloat16]:g} abs+rel), "
                f"{rel:.3g} of max |logit|, bit-identical "
                f"{bool(torch.equal(split, whole))}; whole {t_whole:.2f} s, "
                f"blocks {t_split:.2f} s (host clock, prefill included)")
        else:
            same = bool(torch.equal(split_toks, toks))
            log(f"[50 serve split moe] {c.name} float32, {SM_LAYERS} "
                f"layers: greedy tokens of the blocked run identical to the "
                f"whole run's: {same} ({toks.numel()} tokens); logits "
                f"{rel:.3g} of max |logit| apart")
            assert same, (split_toks, toks)
        out[dt] = rel
        del model, params, whole, split
        torch.cuda.empty_cache()
    launches = {"moe_gmm": moe_gmm.launches - n_k4,
                "flash_attention": flash_attention.launches - n_k1}
    # prefill and decode steps, whole and blocked, 3 K4 launches a layer:
    # each blocked call launches 16 times the whole call's
    want = 2 * (SV_STEPS + 1) * SM_LAYERS * 3 * (1 + SM_EXPERT_BLOCKS)
    assert launches["moe_gmm"] == want, (launches, want)
    took = time.perf_counter() - t0
    log(f"[50 serve split moe] launches in the served runs {launches}; the "
        f"phase took {took:.1f} s")
    return {"K4": rows, "K1": k1, "seconds": took, **launches}


# phase 51: whisper, hymba and the xLSTM served split over ``model``.
# The kernels at the 16x16 prefill ranks the dry-run reports: K5 at
# hymba's (2 rows of 32768, its 3200 SSM channels over 16), K1 at
# whisper's decoder (2 rows of 32768, 20 heads of 64: 20 does not divide
# 16, so every rank runs them all), K6 at the xLSTM's (unsplit: 2 rows,
# 4 heads of 384)
SR_K5 = dict(B=2, S=32768, Din=3200 // 16, N=16)
SR_K1 = dict(B=2, S=32768, H=20, KH=20, D=64)
SR_K6 = dict(B=2, H=4, S=32768, D=384, DV=384)
# hymba cut to 4 layers (layer 0 global, 1-3 windows of 2048) and whisper
# to 4 + 4 layers, both at full width; 4 slots with prompts of 2560 (past
# hymba's window, so its rings wrap), phase 49's cache, blocks and steps
SR_LAYERS, SR_SLOTS, SR_PROMPT = 4, 4, 2560
FRAME_STD = 1.0  # whisper's random frames: about its encoder inputs' size


def _sr_config(arch: str, dt: str):
    cfg = get_config(arch)
    over = dict(dtype=dt, num_layers=SR_LAYERS)
    if cfg.is_encoder_decoder:
        over["encoder_layers"] = SR_LAYERS
    else:
        over["global_attn_layers"] = (0,)
    return dataclasses.replace(cfg, **over)


def _served_stepwise(model, params, tokens, steps, blocks, extra):
    """The prefill, then ``steps`` greedy decode steps reading the cache
    whole; before each, the same step from a copy of the same cache with
    the cache read in ``blocks`` merged blocks.  Returns both runs'
    logits of every step: each step's difference is the blocked read's
    own, not compounded through the decode's state (a recurrent state
    carries a one-ulp bf16 difference into every later step)."""
    logits, cache = model.prefill(params, tokens, extra, max_seq=SV_CACHE)
    whole, split = [logits.float()], [logits.float()]
    for _ in range(steps):
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        other = tree_map(lambda x: x.clone(), cache)
        split.append(model.decode_step(params, other, nxt,
                                       kv_blocks=blocks)[0].float())
        del other
        logits, cache = model.decode_step(params, cache, nxt)
        whole.append(logits.float())
    torch.cuda.synchronize()
    return torch.stack(whole), torch.stack(split)


def phase_serve_split_recurrent(gen) -> dict:
    """51: K5 and K6 with their final states and K1 at the split prefill
    ranks of hymba, the xLSTM and whisper (``SR_*``), bf16, each against
    its plain version beside its bound (K1 beside SDPA); then hymba and
    whisper at full width, cut to ``SR_LAYERS`` layers, their global or
    self-attention caches read whole and in 16 merged blocks (the
    arithmetic of the decode on a cache split over 16 ranks; hymba's
    rings read whole): in bf16 each step from the same cache and token
    (:func:`_served_stepwise`), logits within ``TOL``'s bf16 2e-2 of
    the max |logit| (a logit near 0 moves by its row's rounding: hymba's
    moved 0.039 beside a max |logit| of 4.2, past an abs+rel bound of
    2e-2 there; NVIDIA H100 80GB HBM3, 700 W);
    in float32, each run choosing its own greedy tokens over all the
    steps: identical.  Returns the kernel rows and the served runs'
    launches."""
    t0 = time.perf_counter()
    k5 = _k5_state_case("hymba prefill_32k 16x16 rank", torch.bfloat16,
                        *SR_K5.values(), gen, tag="51", plain_reps=0,
                        exact=False)
    torch.cuda.empty_cache()
    t_k5 = time.perf_counter() - t0
    k1 = _k1_split_prefill_case(gen, SR_K1, "51 K1 split prefill",
                                "whisper-large-v3's decoder")
    torch.cuda.empty_cache()
    t_k1 = time.perf_counter() - t0 - t_k5
    k6 = _k6_state_case("xLSTM prefill_32k 16x16 rank", torch.bfloat16,
                        *SR_K6.values(), gen, tag="51", plain_reps=0)
    torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t0
    n_k1, n_k5, n_st = (flash_attention.launches, ssm_scan.launches,
                        ssm_scan.state_launches)
    out = {}
    for arch in ("hymba-1.5b", "whisper-large-v3"):
        for dt in ("bfloat16", "float32"):
            c = _sr_config(arch, dt)
            model = build_model(c)
            params = model.serving_params(model.init(seed=0))
            tokens = torch.randint(0, c.vocab_size, (SR_SLOTS, SR_PROMPT),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)
            extra = None
            if c.is_encoder_decoder:
                extra = {"frames": (FRAME_STD * torch.randn(
                    (SR_SLOTS, c.encoder_frames, c.d_model),
                    generator=gen, device="cuda")).to(getattr(torch, dt))}
            else:
                assert SR_PROMPT > c.sliding_window, c.sliding_window
            what = (f"{c.name} {dt}, {c.num_layers} layers"
                    + (f" + {c.encoder_layers} encoder layers"
                       if c.is_encoder_decoder else
                       f" (layer 0 global, window {c.sliding_window})"))
            t1 = time.perf_counter()
            if dt == "bfloat16":
                whole, split = _served_stepwise(model, params, tokens,
                                                SV_STEPS, SV_BLOCKS, extra)
            else:
                whole, toks = _served(model, params, tokens, SV_STEPS, 1,
                                      extra=extra)
                split, split_toks = _served(model, params, tokens, SV_STEPS,
                                            SV_BLOCKS, extra=extra)
            took_runs = time.perf_counter() - t1
            assert bool(torch.isfinite(split).all()) and split.shape == (
                SV_STEPS + 1, SR_SLOTS, c.vocab_size), split.shape
            rel = float((split - whole).abs().max() / whole.abs().max())
            if dt == "bfloat16":
                err = float((split - whole).abs().max())
                log(f"[51 serve split recurrent] {what}, {SR_SLOTS} "
                    f"slots, cache {SV_CACHE}, prompt {SR_PROMPT}, "
                    f"{SV_STEPS} steps: each step's read of the cache in "
                    f"{SV_BLOCKS} blocks merged vs read whole, from the same "
                    f"cache and token: max |diff| of the logits {err:.4g}, "
                    f"{rel:.3g} of max |logit| {float(whole.abs().max()):.4g}"
                    f" (bound {TOL[torch.bfloat16]:g} of it); {took_runs:.2f}"
                    f" s (host clock, prefill included)")
                assert rel <= TOL[torch.bfloat16], (rel, what)
            else:
                same = bool(torch.equal(split_toks, toks))
                log(f"[51 serve split recurrent] {what}: greedy tokens of "
                    f"the merged read identical to the whole read's: {same} "
                    f"({toks.numel()} tokens); logits {rel:.3g} of max "
                    f"|logit| apart")
                assert same, (split_toks, toks)
            out[(arch, dt)] = rel
            del model, params, whole, split, extra
            torch.cuda.empty_cache()
    launches = {"flash_attention": flash_attention.launches - n_k1,
                "ssm_scan": ssm_scan.launches - n_k5,
                "ssm_scan_state": ssm_scan.state_launches - n_st}
    # hymba's prefill launches K1 and K5 (with its state) once a layer;
    # whisper's K1 three times a layer (encoder, decoder, cross); 3
    # prefills each (bf16's one, float32's whole and blocked runs)
    want = {"flash_attention": 3 * SR_LAYERS * (1 + 3),
            "ssm_scan": 3 * SR_LAYERS, "ssm_scan_state": 3 * SR_LAYERS}
    assert launches == want, (launches, want)
    took = time.perf_counter() - t0
    log(f"[51 serve split recurrent] launches in the served runs "
        f"{launches}; the phase took {took:.1f} s ({t_kernels:.1f} s the "
        f"kernels' checks and times: K5 {t_k5:.1f}, K1 {t_k1:.1f}, K6 "
        f"{t_kernels - t_k5 - t_k1:.1f})")
    return {"K5": k5, "K1": k1, "K6": k6, "seconds": took, **launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    # the card: registered, planned for, trained on, calibrated from.
    # First after the build: phase 31's fit holds host-clock step times,
    # which a full run's earlier phases left slower at global batch 2
    # (ROADMAP §3)
    phase_card_catalog()
    with tempfile.TemporaryDirectory() as runs:
        card, card_runs = phase_card_train_workflow(runs)
        phase_card_calibrate_explore(runs, card_runs)
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
    legacy_k1 = phase_serve_legacy(model, params, cfg)
    k3_launches = phase_serve_spec(model, params, cfg)
    del model, params
    torch.cuda.empty_cache()

    k1_bwd, k1_train = phase_k1_train(gen)
    model, state, train_launches, none = phase_train(cfg)
    phase_train_plain(model, state, cfg)
    del model, state
    torch.cuda.empty_cache()
    dots = phase_train_dots(cfg, none)
    phase_resume(dataclasses.replace(cfg, num_layers=2,
                                     name=cfg.name + "-2layer"), 12,
                 "depth cut to 2 layers")

    xcfg = get_config("xlstm-125m")
    k6, k6_bwd = phase_k6(gen, xcfg)
    model, state, xl_launches = phase_xlstm_train(xcfg)
    phase_xlstm_plain(xcfg, state)
    del model, state
    torch.cuda.empty_cache()
    # depth cut to one group (3 mLSTM + 1 sLSTM blocks) to keep the
    # script's time: the sLSTM loop is host bound
    phase_resume(dataclasses.replace(xcfg, num_layers=xcfg.slstm_every,
                                     name=xcfg.name + "-1group"), 16,
                 "full width, depth cut to one group of 4 blocks")

    hcfg = get_config("hymba-1.5b")
    k5, k5_bwd = phase_k5(gen, hcfg)
    phase_k1_hymba(gen, hcfg)
    hy_launches = phase_hymba_train(hcfg)
    torch.cuda.empty_cache()
    # depth cut to 2 layers, layer 0 global and layer 1 windowed: the plain
    # scan is thousands of launches a layer
    cut = dataclasses.replace(hcfg, num_layers=2, global_attn_layers=(0,),
                              name=hcfg.name + "-2layer")
    phase_hymba_plain(cut)
    torch.cuda.empty_cache()
    phase_resume(cut, 21, "full width, depth cut to 2 layers: 0 global, 1 a "
                 f"{cut.sliding_window} window", seq=HY_SEQ, batch=1)
    torch.cuda.empty_cache()

    mcfg = get_config("phi3.5-moe-42b-a6.6b")
    mgen = torch.Generator(device="cuda").manual_seed(16)
    k4 = phase_k4(mgen, mcfg, get_config("qwen3-moe-235b-a22b"))
    phase_moe_gmm_bwd(mgen, mcfg)
    moe_launches = phase_moe_train(_moe_cut(mcfg))
    torch.cuda.empty_cache()
    phase_moe_plain(_moe_cut(mcfg))
    torch.cuda.empty_cache()
    phase_resume(_moe_cut(mcfg, d_ff=256), 26,
                 "full d_model and heads, 16 experts top-2, depth cut to 2 "
                 "layers and d_ff to 256")
    torch.cuda.empty_cache()

    # the serve workflow's launches join the serving main path's below
    wf = phase_serve_workflow()
    phase_train_workflow()

    # whisper-large-v3 and phi-3-vision-4.2b: the slice's kernels at their
    # shapes, then each main path (counters reset just before, read just
    # after each run), then both templates planned for the card
    k3_d96 = phase_slice_kernels(gen)
    wh = phase_whisper(get_config("whisper-large-v3"))
    pv = phase_phi3v(get_config("phi-3-vision-4.2b"))
    with tempfile.TemporaryDirectory() as runs:
        sw = phase_slice_workflows(runs)

    # serving the MoE decoders, hymba and the xLSTM: K5 and K6 with their
    # final state and K4 at the serving shapes, then each main path
    # (counters reset just before, read just after each run)
    sk = phase_serve_kernels(torch.Generator(device="cuda").manual_seed(36),
                             hcfg, xcfg, mcfg)
    ms = phase_moe_serve(mcfg)
    hs = phase_hymba_serve(hcfg)
    xs = phase_xlstm_serve(xcfg)
    with tempfile.TemporaryDirectory() as runs:
        ht = phase_hymba_template(runs)
    state = {"ssm_scan": hs["ssm_scan_state"] + ht["ssm_scan_state"],
             "mlstm_scan": xs["mlstm_scan_state"]}

    # parallelism and elasticity: an NCCL world of one, started here and
    # destroyed after phase 44
    mesh, rt, mt, mesh_base = phase_mesh_train(cfg)
    mc = phase_mesh_compress(cfg, mesh, rt, mesh_base)
    mm = phase_mesh_moe(mcfg, mesh)
    el = phase_elastic(cfg, rt)
    sp = phase_mesh_split(cfg, mesh, rt, mesh_base)
    fam = phase_mesh_families(mesh, rt,
                              torch.Generator(device="cuda").manual_seed(48))
    del mesh, mesh_base
    dist.destroy_process_group()
    par = {k: mt[k] + mc[k] + el[k] + sp[k] + fam["launches"][k]
           for k in ("flash_attention", "flash_attention_bwd")}
    tp = phase_tp_kernels(gen, k1_bwd, k1_train)
    phase_dryrun(cfg)
    sv = phase_serve_split(torch.Generator(device="cuda").manual_seed(49))
    sm = phase_serve_split_moe(
        torch.Generator(device="cuda").manual_seed(50))
    sr = phase_serve_split_recurrent(
        torch.Generator(device="cuda").manual_seed(51))

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             includes=[HOPPER_COMMON],
             replaces="src/repro/kernels/flash_attention.py:115",
             launches=(launches["flash_attention"] + legacy_k1
                       + dots["flash_attention"] + wf["flash_attention"]
                       + card["flash_attention"] + wh["flash_attention"]
                       + pv["flash_attention"] + sw["flash_attention"]
                       + ms["flash_attention"] + hs["flash_attention"]
                       + xs["flash_attention"] + ht["flash_attention"]
                       + par["flash_attention"] + sv["flash_attention"]
                       + sm["flash_attention"] + sr["flash_attention"]),
             hymba_prefill=sk["flash_attention"],
             split_ranks=[fwd for fwd, _ in tp] + [fam["K1"], sv["K1"],
                                                    sm["K1"], sr["K1"]],
             **k1),
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             includes=[PAGED_COMMON, HOPPER_COMMON],
             replaces="src/repro/kernels/paged_attention.py:230",
             launches=(launches["paged_attention"] + wf["paged_attention"]
                       + pv["paged_attention"] + ms["paged_attention"]),
             **k2),
        dict(name="paged_attention_mq", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention_mq.cu",
             includes=[PAGED_COMMON, HOPPER_COMMON],
             replaces="src/repro/kernels/paged_attention.py:170",
             launches=(k3_launches + wf["paged_attention_mq"]
                       + ms["paged_attention_mq"]), **k3),
        dict(name="paged_attention_mq (phi-3-vision verify, D 96, fma walk)",
             route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention_mq.cu",
             includes=[PAGED_COMMON, HOPPER_COMMON],
             replaces="src/repro/kernels/paged_attention.py:170",
             launches=pv["paged_attention_mq"],
             **{k: k3_d96[k] for k in ("max_abs_err", "ms", "ms_cold",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "path")}),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             includes=[HOPPER_COMMON],
             replaces="src/repro/kernels/flash_xla.py:99",
             launches=(train_launches["flash_attention_bwd"]
                       + dots["flash_attention_bwd"]
                       + card["flash_attention_bwd"]
                       + wh["flash_attention_bwd"] + pv["flash_attention_bwd"]
                       + sw["flash_attention_bwd"]
                       + par["flash_attention_bwd"]),
             split_ranks=[bwd for _, bwd in tp] + [fam["K1-bwd"]],
             **k1_bwd),
        dict(name="mlstm_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
             includes=[MLSTM_TC, HOPPER_COMMON],
             replaces="src/repro/kernels/mlstm_scan.py:117",
             launches=xl_launches["mlstm_scan"] + xs["mlstm_scan"],
             state_launches=state["mlstm_scan"],
             with_state=sk["mlstm_scan"], split_prefill_rank=sr["K6"],
             **k6),
        dict(name="mlstm_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/mlstm_scan_bwd.cu",
             includes=[MLSTM_TC, HOPPER_COMMON],
             replaces="src/repro/kernels/ref.py:207",
             launches=xl_launches["mlstm_scan_bwd"], **k6_bwd),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssm_scan.cu",
             includes=[SSM_COMMON],
             replaces="src/repro/kernels/ssm_scan.py:63",
             launches=(hy_launches["ssm_scan"] + hs["ssm_scan"]
                       + ht["ssm_scan"] + fam["launches"]["ssm_scan"]
                       + sr["ssm_scan"]),
             state_launches=state["ssm_scan"] + sr["ssm_scan_state"],
             with_state=sk["ssm_scan"], split_rank=fam["K5"],
             split_prefill_rank=sr["K5"], **k5),
        dict(name="ssm_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
             includes=[SSM_COMMON],
             replaces="src/repro/kernels/ssm_vjp.py:79",
             launches=(hy_launches["ssm_scan_bwd"]
                       + fam["launches"]["ssm_scan_bwd"]),
             split_rank=fam["K5-bwd"], **k5_bwd),
        dict(name="moe_gmm", route="cuda",
             source="src/repro_torch/kernels/csrc/moe_gmm.cu",
             includes=[HOPPER_COMMON],
             replaces="src/repro/kernels/moe_gmm.py:65",
             launches=moe_launches["moe_gmm"] + ms["moe_gmm"]
             + mm["moe_gmm"] + sm["moe_gmm"],
             serving_decode=sk["moe_gmm"], split_ranks=sm["K4"], **k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
