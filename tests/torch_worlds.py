"""Spawned gloo worlds for the port's multi-rank tests on the CPU.

:func:`run_world` starts ``nprocs`` processes (``spawn``), each joining a
gloo world through a ``FileStore`` under the test's ``tmp_path`` (no TCP
port, so parallel test workers never race for one), with one torch
thread each, runs ``fn(rank, *args)`` and returns every rank's result.
A world that does not finish within ``timeout`` seconds is killed and
fails the test, so a hung collective cannot run into the suite's limit.

The world programs live here, apart from the test modules, so a spawned
rank imports torch and the port alone (never JAX).
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 60


def _entry(rank, fn, nprocs, store_path, out_dir):
    torch.set_num_threads(1)
    # each rank loads its own copy: tensors handed to a spawned process
    # would share one storage, and the ranks update their state in place
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    store = dist.FileStore(store_path, nprocs)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nprocs)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn, nprocs: int, tmp_path, *args,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """``[fn(rank, *args) for each rank]`` computed in a spawned gloo
    world of ``nprocs`` ranks; raises if a rank fails or the world
    outlives ``timeout``."""
    out_dir = os.path.join(str(tmp_path), f"world{nprocs}-{time.time_ns()}")
    os.makedirs(out_dir)
    store_path = os.path.join(out_dir, "store")
    torch.save(args, os.path.join(out_dir, "args.pt"))
    ctx = mp.start_processes(_entry, args=(fn, nprocs, store_path, out_dir),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {nprocs} ranks outlived "
                                   f"{timeout} s")
    except Exception as e:
        errs = [open(os.path.join(out_dir, n)).read()
                for n in sorted(os.listdir(out_dir)) if n.endswith(".err")]
        raise RuntimeError("\n".join(errs) or str(e)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(nprocs)]


# ---------------------------------------------------------------------------
# world programs
def _model(arch: str, over: dict):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              **over)
    return build_model(cfg, "cpu")


def train_world(rank, mesh_shape, cases):
    """Each case ``{"arch", "over", "plan", "opt", "state", "batches"}``
    (the whole initial state and the global batches): the sharded step
    from the state over the batches on a ``mesh_shape`` ``("data",
    "model")`` mesh.  Returns per case the metrics of each step, the
    final state gathered whole (rank 0) and this rank's blocks with
    their place (each rank)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import gather_tree, shard_tree
    from repro_torch.train import (OptimizerConfig, Plan,
                                   make_train_artifacts, shard_batch)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.tree import flatten

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    out = {}
    for name, case in cases.items():
        model = _model(case["arch"], case["over"])
        plan = Plan(**case["plan"])
        B, S = case["batches"][0]["tokens"].shape
        art = make_train_artifacts(model, mesh, plan,
                                   OptimizerConfig(**case["opt"]),
                                   ShapeConfig("t", S, B, "train"))
        state = shard_tree(case["state"], art.state_shardings)
        metrics = []
        for batch in case["batches"]:
            state, m = art.step_fn(state, shard_batch(batch, mesh, plan))
            metrics.append({k: float(v) for k, v in m.items()})
        whole = gather_tree(state, art.state_shardings)
        places = {k: (s.spec, {a: mesh.coord(a) for a in mesh.shape})
                  for k, s in flatten(art.state_shardings)}
        out[name] = {"metrics": metrics, "local": state, "places": places,
                     "whole": whole if rank == 0 else None}
        if name == "dense":
            out[name]["compressed"] = _compress_check(rank, model, mesh,
                                                      plan)
    return out


def _compress_check(rank, model, mesh, plan):
    """The mesh step's compression of a gradient and an error made from a
    seed (whole leaves, split by the parameters' layouts): the inputs
    and the compressed gradient and new error gathered whole."""
    from repro_torch.train.step import _Layout

    layout = _Layout(model, mesh, plan)
    gen = torch.Generator().manual_seed(7)
    inputs = {}
    for key, sh in zip(layout.paths, layout.flat):
        g = torch.randn(sh.shape, generator=gen) * 0.01
        inputs[key] = (g, torch.randn(sh.shape, generator=gen) * 1e-4)
    grads = [sh.local(inputs[k][0]).clone()
             for k, sh in zip(layout.paths, layout.flat)]
    errs = [sh.local(inputs[k][1]).clone()
            for k, sh in zip(layout.paths, layout.flat)]
    layout.compress(grads, errs)
    g_whole = {k: sh.full(g) for k, sh, g in zip(layout.paths, layout.flat,
                                                  grads)}
    e_whole = {k: sh.full(e) for k, sh, e in zip(layout.paths, layout.flat,
                                                  errs)}
    return {"inputs": inputs, "g": g_whole, "e": e_whole} \
        if rank == 0 else None


def moe_layer_world(rank, mesh_shape, cfg_over, p, x):
    """The expert-parallel MoE layer on a mesh: each rank's rows of ``x``
    and its local experts of ``p``; ``loss = sum(out**2) + aux`` over the
    global batch.  Returns the whole output, the aux loss and the whole
    gradient of every parameter (rank 0)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import collectives

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    cfg = _model("phi3.5-moe-42b-a6.6b", cfg_over).cfg
    xl = collectives.slice_block(x, 0, mesh, "data").contiguous()
    local = {k: (v if k == "router"
                 else collectives.slice_block(v, 0, mesh, "model"))
             .contiguous().requires_grad_(True) for k, v in p.items()}
    with moe.moe_impl("shard_map", mesh, ("data",)):
        out, aux = moe.apply_moe(local, xl, cfg)
        loss = (out ** 2).sum() + aux
        names = sorted(local)
        grads = torch.autograd.grad(loss, [local[k] for k in names])
    grads = {k: collectives.all_reduce(g.clone(), mesh, "data")
             for k, g in zip(names, grads)}
    grads = {k: (g if k == "router"
                 else collectives.all_gather_dim(g, 0, mesh, "model"))
             for k, g in grads.items()}
    whole = collectives.all_gather_dim(out.detach().contiguous(), 0, mesh,
                                       "data")
    return {"out": whole, "aux": float(aux), "grads": grads} \
        if rank == 0 else None


def layer_split_world(rank, mesh_shape, w, x):
    """A stacked leaf ``w`` ``(L, d, n)`` whose ``layers`` dim is split
    over "data" (as FSDP splits hymba's SSM matrices on 16×16) and whose
    ``n`` is split over "model" and kept there, read a layer at a time
    under a gathering: ``loss = sum_i sum((x_r @ w_i)**2)`` over each data
    rank's rows ``x_r`` and each model rank's columns.  Returns (rank 0)
    the loss summed over the mesh and the gradient gathered whole, and
    each layer's gathered block on every rank."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives, fsdp
    from repro_torch.parallel.sharding import Sharding

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    sh = Sharding(mesh, (("data",), (), ("model",)), tuple(w.shape))
    local = sh.local(w).contiguous().requires_grad_(True)
    xl = collectives.slice_block(x, 0, mesh, "data")
    g = fsdp.Gathering([local], [fsdp.Leaf(mesh, sh.spec, (2,), ("data",))])
    seen = []
    with fsdp.installed(g):
        loss = 0.0
        for p in fsdp.layers({"w": local}):
            wi = fsdp.layer(p)["w"]
            seen.append(wi.detach().clone())
            loss = loss + ((xl @ wi) ** 2).sum()
        grad, = torch.autograd.grad(loss, [local])
    total = collectives.all_reduce(loss.detach().reshape(1).clone(), mesh,
                                   ("data", "model"))
    whole = sh.full(grad.contiguous())
    return {"loss": float(total), "grad": whole if rank == 0 else None,
            "local_shape": tuple(grad.shape), "seen": seen,
            "model": mesh.coord("model")}


def parallel_world(rank, mesh_shape, cases, layer, split_leaf):
    """:func:`train_world`'s cases, :func:`moe_layer_world`'s layer
    (``{"over", "p", "x"}``) and :func:`layer_split_world`'s leaf
    (``{"w", "x"}``) in one world."""
    return {"train": train_world(rank, mesh_shape, cases),
            "layer": moe_layer_world(rank, mesh_shape, layer["over"],
                                     layer["p"], layer["x"]),
            "split_leaf": layer_split_world(rank, mesh_shape,
                                            split_leaf["w"],
                                            split_leaf["x"])}


def count_collectives(rank, mesh_shape, case):
    """One sharded step of ``case`` (as :func:`train_world`'s) with
    ``collectives.reduce_sum`` and ``collectives.all_gather_dim`` wrapped:
    each call's ``(name, axes, input shape)`` in order (rank 0)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives, shard_tree
    from repro_torch.train import (OptimizerConfig, Plan,
                                   make_train_artifacts, shard_batch)

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    model = _model(case["arch"], case["over"])
    plan = Plan(**case["plan"])
    B, S = case["batches"][0]["tokens"].shape
    art = make_train_artifacts(model, mesh, plan,
                               OptimizerConfig(**case["opt"]),
                               ShapeConfig("t", S, B, "train"))
    state = shard_tree(case["state"], art.state_shardings)
    calls = []
    wrapped = {}

    def wrap(name, fn, shape_of):
        def call(*args, **kw):
            x, axes = shape_of(*args)
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            calls.append((name, axes, tuple(x.shape)))
            return fn(*args, **kw)
        return call

    for name, shape_of in (
            ("reduce_sum", lambda x, mesh_, axes: (x, axes)),
            ("all_gather_dim", lambda x, dim, mesh_, axes: (x, axes))):
        wrapped[name] = getattr(collectives, name)
        setattr(collectives, name, wrap(name, wrapped[name], shape_of))
    try:
        art.step_fn(state, shard_batch(case["batches"][0], mesh, plan))
    finally:
        for name, fn in wrapped.items():
            setattr(collectives, name, fn)
    return calls if rank == 0 else None


def tensor_world(rank, mesh_shape, cases, count_cases):
    """:func:`train_world`'s cases and :func:`count_collectives`' step of
    each of ``count_cases`` (by name) in one world."""
    return {"train": train_world(rank, mesh_shape, cases),
            "calls": {name: count_collectives(rank, mesh_shape, case)
                      for name, case in count_cases.items()}}


def psum_world(rank, stacked, err):
    """``compressed_psum`` over a ``(world,)`` mesh: rank ``r`` reduces
    ``stacked[r]`` with its error ``err[r]``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compression import compressed_psum

    mesh = make_mesh((dist.get_world_size(),), ("data",), device="cpu")
    return compressed_psum(stacked[rank], mesh, "data", err[rank])


def elastic_world(rank, mesh_shape, case, ckpt_dir, mode):
    """``mode="save"``: ``reshard_state`` of the whole state, one sharded
    step, a save through the layouts, one more step; returns (rank 0) the
    state after each step, whole.  ``mode="restore"``: ``elastic_restart``
    onto this world's mesh, then one step; returns (rank 0) the restored
    state and the state after the step, whole."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.ft import elastic_restart, reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import gather_tree
    from repro_torch.train import (OptimizerConfig, Plan,
                                   make_train_artifacts, shard_batch)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.tree import tree_map

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    model = _model(case["arch"], case["over"])
    plan = Plan(**case["plan"])
    B, S = case["batches"][0]["tokens"].shape
    art = make_train_artifacts(model, mesh, plan,
                               OptimizerConfig(**case["opt"]),
                               ShapeConfig("t", S, B, "train"))
    ck = Checkpointer(ckpt_dir, keep=2)
    lay = art.state_shardings

    def step(state, i):
        return art.step_fn(state, shard_batch(case["batches"][i], mesh,
                                              plan))[0]

    if mode == "save":
        state = step(reshard_state(case["state"], model, mesh, plan), 0)
        ck.save(0, state, shardings=lay, blocking=True)
        # a copy: a leaf held whole is the state's own tensor, which the
        # next step updates in place
        first = tree_map(lambda x: x.detach().clone(),
                         gather_tree(state, lay))
        second = gather_tree(step(state, 1), lay)
        return (first, second) if rank == 0 else None
    state, saved = elastic_restart(ck, case["state"], model, mesh, plan)
    restored = tree_map(lambda x: x.detach().clone(),
                        gather_tree(state, lay))
    after = gather_tree(step(state, saved + 1), lay)
    return (restored, after, saved) if rank == 0 else None


def serve_world(rank, mesh_shape, cases, max_seq, steps):
    """Each case ``{"arch", "over", "params", "tokens", "lens"}`` (the
    whole parameters, the global right-padded prompts and their lengths,
    or None: whole rows), and optionally ``"extra"`` (the global extra
    inputs, each with the batch first: the VLM's image embeddings, the
    encoder-decoder's frames):
    ``serve/sharded.py``'s split prefill of this rank's rows into a cache
    of ``max_seq`` positions, then ``steps`` greedy decode steps.
    Returns per case this rank's logits of every step (whole over the
    vocab), its greedy tokens, its cache block after the prefill and
    after the last step, its place on the mesh, and the MoE prefill's
    (kept, all) routed entries of its rows (None for another family)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import shard_tree
    from repro_torch.parallel.sharding import Plan, Sharding
    from repro_torch.serve.sharded import make_serve_artifacts
    from repro_torch.tree import tree_map

    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    out = {}
    for name, case in cases.items():
        model = _model(case["arch"], case["over"])
        tokens, lens = case["tokens"], case["lens"]
        B = tokens.shape[0]
        art = make_serve_artifacts(model, mesh, Plan(), B, max_seq)
        params = shard_tree(case["params"], art.param_shardings)

        def local(x):
            return Sharding(mesh, (("data",),) + ((),) * (x.dim() - 1),
                            tuple(x.shape)).local(x)

        extra = {k: local(v) for k, v in case.get("extra", {}).items()}
        moe.drop_stats = [] if model.cfg.num_experts else None
        try:
            logits, cache = art.prefill_fn(
                params, local(tokens), extra or None,
                lens=None if lens is None else local(lens))
            drops = None if moe.drop_stats is None else tuple(
                int(sum(int(s[i]) for s in moe.drop_stats)) for i in (0, 1))
        finally:
            moe.drop_stats = None
        first = tree_map(lambda x: x.clone(), cache)
        seen, chosen = [logits], []
        for _ in range(steps):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            chosen.append(nxt)
            logits, cache = art.decode_fn(params, cache, nxt)
            seen.append(logits)
        out[name] = {"logits": torch.stack(seen), "tokens": torch.cat(
            chosen, 1), "prefill_cache": first, "cache": cache,
            "data": mesh.coord("data"), "model": mesh.coord("model"),
            "drops": drops}
    return out
