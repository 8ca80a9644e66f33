"""The port's dry-run (``launch/op_stats.py``, ``launch/cells.py``,
``launch/dryrun.py``, ``launch/reanalyze.py``, ``launch/hillclimb.py``)
held against the reference's analyzer, on the CPU.

The fake-world cases (the production meshes over fake worlds of 256 and
512 ranks, reduced train cells over a fake (4, 4) world, the probe's
reduced qwen2 cell over a fake world of one, the dry-run CLI and
``reanalyze``) run in ONE subprocess, started when the module's first
test runs and read by the tests that need it: a test worker may already
hold a gloo world, and a process never holds a fake world beside a real
one.  The analyzer cases, the kernels' counting on CPU tensors and the
planner's hill-climb run in process.

Tolerances, each with its reason:

  * analyzer FLOPs exact (integers in float64): a scan of L dots forward
    and backward is 3·L·2·B·D², nested loops L1·L2·2·B·D², and both equal
    the reference's ``analyze_hlo`` of the same JAX function;
  * the reduced qwen2 cell (seq 64, batch 4, remat none, the reference's
    ``analyze_hlo`` on a (1, 1) mesh): rtol 1e-6, after one explained
    term (see :func:`test_reduced_qwen2_flops_against_reference`);
  * collective bytes exact: the reckoning from the state's layouts is in
    :func:`_expected_collectives`;
  * every kernel call counted once with its formula's FLOPs, exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.kernels import work

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": f"{REPO}/src"}

# the fake (4, 4) world's reduced cells: seq 32, global batch 8
SEQ, BATCH = 32, 8
ARCHS = ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-125m",
         "whisper-large-v3", "phi-3-vision-4.2b")
# the fake world's serving cells are the registry's shapes, but for the
# xLSTM's prefill, whose sLSTM loop runs a step a position on fake
# tensors (219 s at 32768): its sequence cut to this
XLSTM_PREFILL_SEQ = 1024

WORLD_CODE = r'''
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from repro_torch.configs import all_cells, get_config, get_shape, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.cells import (analyze_cell, build_cell, count_cell,
                                      default_plan)
from repro_torch.launch.mesh import (ensure_world, fake_world, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.op_stats import analyze_ops
from repro_torch.train.step import GATHER_AND_REPEAT, _Layout, state_layouts
from repro_torch.models.api import Model
from repro_torch.tree import leaves as tree_leaves

SEQ, BATCH, ARCHS, XLSTM_PREFILL_SEQ = json.loads(sys.argv[1])
out = {"all_cells": list(all_cells())}  # a fresh process: no derived shape

# a real world refuses a fake one
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    fake_world(4)
    out["real_refuses_fake"] = False
except RuntimeError as e:
    out["real_refuses_fake"] = str(e)
dist.destroy_process_group()

m1 = make_production_mesh()
out["single"] = [list(m1.shape.values()), list(m1.axis_names),
                 dist.get_world_size()]
try:
    ensure_world("cuda")
    out["fake_refuses_cuda"] = False
except RuntimeError as e:
    out["fake_refuses_cuda"] = str(e)
m2 = make_production_mesh(multi_pod=True)
out["multi"] = [list(m2.shape.values()), list(m2.axis_names),
                dist.get_world_size()]

fake_world(16)
mesh = make_mesh((4, 4), device="cpu")
shape = ShapeConfig("t", SEQ, BATCH, "train")
cells = {}
for arch in ARCHS:
    cfg = reduced(get_config(arch))
    plan = default_plan(cfg, mesh)
    cell = build_cell(arch, "train_4k", mesh, plan, cfg=cfg, shape=shape)
    st, ops = count_cell(cell)
    model = Model(cfg, mesh.device)
    params = tree_leaves(state_layouts(model, mesh, plan, False)["params"])
    # the dims the compute keeps split, and the axes each gradient is
    # summed over, from the step's own bookkeeping
    lay = _Layout(model, mesh, plan)
    leaves = []
    for sh, path, lf in zip(params, lay.paths,
                            lay.leaf_plans(lay.split(SEQ))):
        leaves.append({
            "path": path, "shape": list(sh.shape),
            "spec": [list(e) for e in sh.spec], "keep": list(lf.keep),
            "axes": list(lf.axes)})
    st["record_again"] = analyze_ops(json.loads(json.dumps(ops)))["flops"]
    cells[arch] = {"stats": st, "leaves": leaves,
                   "tp": cfg.family not in GATHER_AND_REPEAT,
                   "dp": list(lay.dp)}
    serving = {}
    for name in ("prefill_32k", "decode_32k"):
        sshape = get_shape(name)
        if cfg.family == "ssm" and sshape.kind == "prefill":
            sshape = ShapeConfig(name, XLSTM_PREFILL_SEQ,
                                 sshape.global_batch, "prefill")
        sst = analyze_cell(build_cell(arch, name, mesh, cfg=cfg,
                                      shape=sshape))
        serving[name] = {"args": sst["argument_size_in_bytes"],
                         "flops": sst["flops"], "seq": sshape.seq_len,
                         "kernels": sst["hlo_stats"]["kernels"],
                         "collectives": sst["collectives"]["total_ops"]}
    cells[arch]["serving"] = serving
out["cells"] = cells

# a reduced MoE decode cell on a fake (1, 4) world: the serving layout
# (the experts held split over model), and the same cell on a layout that
# puts no experts on model (the experts gathered whole, the unsplit layer)
fake_world(4)
mesh14 = make_mesh((1, 4), device="cpu")
mcfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
whole = {"vocab": "model", "heads": "model", "mlp": "model"}
moe_cells = {}
for tag, kw in (("split", {}), ("whole", {"logical": whole})):
    mst = analyze_cell(build_cell("phi3.5-moe-42b-a6.6b", "decode_32k",
                                  mesh14, default_plan(mcfg, mesh14, **kw),
                                  cfg=mcfg))
    moe_cells[tag] = {"args": mst["argument_size_in_bytes"],
                      "temp": mst["temp_size_in_bytes"],
                      "K4": mst["hlo_stats"]["kernels"]["K4"],
                      "ops": mst["collectives"]["op_count_by_kind"]}
out["moe_decode_1x4"] = moe_cells

# every serving cell of the production meshes: built, or refused
serving_cells = {}
for multi in (False, True):
    fake_world(512 if multi else 256)
    pmesh = make_production_mesh(multi_pod=multi)
    for arch, name, ok, _ in all_cells():
        if not ok or get_shape(name).kind == "train":
            continue
        key = "|".join((arch, name, "2x16x16" if multi else "16x16"))
        try:
            build_cell(arch, name, pmesh)
            serving_cells[key] = "ok"
        except NotImplementedError as e:
            serving_cells[key] = str(e)
out["serving_cells"] = serving_cells

# the probe's cell on one device: a fake world of one
fake_world(1)
mesh1 = make_mesh((1, 1), device="cpu")
cfg = reduced(get_config("qwen2-1.5b"))
st = analyze_cell(build_cell("qwen2-1.5b", "train_4k", mesh1,
                             default_plan(cfg, mesh1, remat="none"), cfg=cfg,
                             shape=ShapeConfig("t", 64, 4, "train")))
out["one"] = st
# a serving cell on a mesh whose model axis is 1 builds and counts
pcell = build_cell("qwen2-1.5b", "prefill_32k", mesh1, cfg=cfg,
                   shape=ShapeConfig("p", 64, 2, "prefill"))
out["prefill_one"] = analyze_cell(pcell)["hlo_stats"]["kernels"]

# the CLI: one train cell and the serving cells on 16x16, then reanalyze
with tempfile.TemporaryDirectory() as d:
    res, hlo = os.path.join(d, "r.json"), os.path.join(d, "hlo")
    for arch, shp in (("qwen2-1.5b", "train_4k"),
                      ("qwen2-1.5b", "prefill_32k"),
                      ("qwen2-1.5b", "decode_32k"),
                      ("hymba-1.5b", "decode_32k"),
                      ("hymba-1.5b", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shp, "--mesh", "single",
                     "--out", res, "--hlo-dir", hlo])
    before = json.load(open(res))
    reanalyze.main(["--out", res, "--hlo-dir", hlo])
    after = json.load(open(res))
    out["cli"] = {"before": before, "after": after,
                  "records": sorted(os.listdir(hlo))}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def _world_proc():
    """The fake-world subprocess, started at the module's first test."""
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORLD_CODE),
         json.dumps([SEQ, BATCH, ARCHS, XLSTM_PREFILL_SEQ])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start(_world_proc):
    return _world_proc


_RESULT = {}


@pytest.fixture
def world(_world_proc):
    if "out" not in _RESULT:
        stdout, stderr = _world_proc.communicate(timeout=240)
        assert _world_proc.returncode == 0, stderr[-4000:]
        _RESULT["out"] = json.loads(stdout.strip().splitlines()[-1])
    return _RESULT["out"]


# ---------------------------------------------------------------------------
# the analyzer against the reference's (in process)
# ---------------------------------------------------------------------------
def _count(fn, *args):
    from repro_torch.launch.op_stats import OpCounter

    with OpCounter() as c:
        fn(*args)
    return c.stats()


def test_scan_of_dots_counts_fwd_and_bwd_like_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_stats import analyze_hlo

    L, B, D = 5, 8, 64
    x = torch.randn(B, D, requires_grad=True)
    w = torch.randn(L, D, D, requires_grad=True)

    def f(x, w):
        c = x
        for i in range(L):
            c = torch.tanh(c @ w[i])
        return torch.autograd.grad(c.sum(), (x, w))

    st = _count(f, x, w)

    def jf(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()

    comp = jax.jit(jax.grad(jf, argnums=(0, 1))).lower(
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, D, D), jnp.float32)).compile()
    ref = analyze_hlo(comp.as_text())
    expect = 3 * L * 2 * B * D * D  # fwd + 2 bwd dots per layer
    assert st["flops"] == expect == ref["flops"]
    assert st["collective_ops"] == {} and st["total_collective_bytes"] == 0


def test_nested_loops_count_like_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_stats import analyze_hlo

    B, D, L1, L2 = 4, 32, 3, 7
    x, w = torch.randn(B, D), torch.randn(D, D)

    def f(x, w):
        for _ in range(L1):
            for _ in range(L2):
                x = torch.tanh(x @ w)
        return x

    st = _count(f, x, w)

    def jf(x, w):
        def outer(c, _):
            def inner(ci, _):
                return jnp.tanh(ci @ w), None
            ci, _ = jax.lax.scan(inner, c, None, length=L2)
            return ci, None
        y, _ = jax.lax.scan(outer, x, None, length=L1)
        return y

    comp = jax.jit(jf).lower(jax.ShapeDtypeStruct((B, D), jnp.float32),
                             jax.ShapeDtypeStruct((D, D), jnp.float32)
                             ).compile()
    expect = L1 * L2 * 2 * B * D * D
    assert st["flops"] == expect == analyze_hlo(comp.as_text())["flops"]


def test_flops_agree_with_flop_counter_mode():
    """Every op both count (mm, bmm, addmm, baddbmm, convolution and its
    backward): the same formulas, so the same totals; the saved record
    analyzed again gives them too."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.op_stats import OpCounter, analyze_ops

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, 16, generator=g, requires_grad=True)
    cw = torch.randn(8, 3, 3, 3, generator=g, requires_grad=True)
    a = torch.randn(4, 5, 6, generator=g)
    b = torch.randn(4, 6, 7, generator=g)
    lin = torch.nn.Linear(7, 9)

    def f():
        y = torch.nn.functional.conv2d(x, cw, padding=1).sum()
        z = torch.baddbmm(torch.zeros(4, 5, 7), a, b)
        z = lin(torch.bmm(a, b)).sum() + z.sum()
        torch.autograd.grad(y + z, (x, cw))

    with FlopCounterMode(display=False) as fc:
        f()
    with OpCounter() as c:
        f()
    assert c.stats()["flops"] == fc.get_total_flops() > 0
    assert analyze_ops(json.loads(json.dumps(c.record())))["flops"] \
        == fc.get_total_flops()


def test_peak_follows_live_storages():
    """Temporaries' peak: storages made inside the counter, live at once,
    rounded to 512 bytes; views and arguments add nothing."""
    from repro_torch.launch.op_stats import OpCounter

    arg = torch.zeros(1000)  # 4000 bytes -> 4096
    args = {"a": arg, "view": arg[:10]}
    with OpCounter(track_memory=True) as c:
        assert c.add_arguments(args) == 4096
        t1 = arg * 2          # 4096 live
        t2 = t1.view(10, 100)  # a view: nothing
        t3 = torch.ones(300)  # 1200 -> 1536
        del t1, t2, t3
        t4 = torch.ones(100)  # 512, after the others died
    assert c.peak_bytes == 4096 + 1536
    assert c.live_bytes == 512
    del t4


# ---------------------------------------------------------------------------
# the kernels counted by their own work (in process, CPU tensors)
# ---------------------------------------------------------------------------
def _no_plain(monkeypatch):
    """Make every plain version raise: a counted call must not run one."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     mlstm_scan, moe_gmm, paged_attention,
                                     paged_attention_mq, ref, ssm_scan)

    def boom(*a, **k):
        raise AssertionError("a plain version ran under the counter")

    for mod in (flash_attention, flash_attention_bwd, moe_gmm,
                paged_attention, paged_attention_mq):
        monkeypatch.setattr(mod, "plain", boom)
    for mod in (ssm_scan, mlstm_scan):
        monkeypatch.setattr(mod, "plain", boom)
        monkeypatch.setattr(mod, "plain_bwd", boom)
    for name in ("attention", "attention_fwd", "attention_bwd",
                 "ssm_scan_chunked", "mlstm_scan_chunked", "moe_gmm"):
        monkeypatch.setattr(ref, name, boom)


def _kernel_calls(fn):
    from repro_torch.launch.op_stats import OpCounter

    with OpCounter() as c:
        out = fn()
    calls = {}
    for (name, params), n in c.kernels.items():
        calls.setdefault(name, []).append((json.loads(params), n))
    return out, calls, c.stats()


def test_attention_kernels_count_their_own_work(monkeypatch):
    from repro_torch.kernels import ops

    _no_plain(monkeypatch)
    B, S, H, KH, D = 2, 40, 4, 2, 16
    q = torch.randn(B, S, H, D, requires_grad=True)
    k = torch.randn(B, S, KH, D, requires_grad=True)
    v = torch.randn(B, S, KH, D, requires_grad=True)

    def train():
        out = ops.flash_attention(q, k, v, causal=True, window=8)
        torch.autograd.grad(out.sum(), (q, k, v))
        return out

    out, calls, st = _kernel_calls(train)
    assert out.shape == (B, S, H, D)
    (fwd, nf), = calls["K1"]
    (bwd, nb), = calls["K1-bwd"]
    assert nf == nb == 1
    # window 8, causal: row i sees min(i + 1, 8) keys
    pairs = sum(min(i + 1, 8) for i in range(S))
    assert work.attention_pairs(S, S, True, 8, 0) == pairs
    assert work.work("K1", fwd)["flops"] == 4 * D * B * H * pairs
    assert work.work("K1-bwd", bwd)["flops"] == 10 * D * B * H * pairs
    assert st["kernels"]["K1"]["flops"] == 4 * D * B * H * pairs
    # serving: the forward alone, non-causal against longer keys
    with torch.no_grad():
        _, calls, _ = _kernel_calls(lambda: ops.flash_attention(
            q, torch.randn(B, 50, KH, D), torch.randn(B, 50, KH, D),
            causal=False))
    (fwd, n), = calls["K1"]
    assert n == 1 and work.work("K1", fwd)["flops"] == 4 * D * B * H * S * 50


def test_paged_kernels_count_the_positions_they_walk(monkeypatch):
    from repro_torch.kernels import ops

    _no_plain(monkeypatch)
    B, H, KH, D, P, page, maxp = 2, 4, 2, 16, 8, 4, 3
    pools = [torch.randn(KH, P, page, D) for _ in range(2)]
    table = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    lens = torch.tensor([9, 6], dtype=torch.int32)
    out, calls, _ = _kernel_calls(lambda: ops.paged_decode_attention(
        torch.randn(B, 1, H, D), *pools, table, lens))
    (p2, n), = calls["K2"]
    assert out.shape == (B, 1, H, D) and n == 1
    assert work.work("K2", p2)["flops"] == 4 * D * H * (9 + 6)
    T = 3
    out, calls, _ = _kernel_calls(lambda: ops.paged_decode_attention_mq(
        torch.randn(B, T, H, D), *pools, table, lens))
    (p3, n), = calls["K3"]
    assert out.shape == (B, T, H, D) and n == 1
    # row t of a slot sees base + t positions (capped by the table)
    seen = sum(min(b + t, maxp * page) for b in (9, 6) for t in range(T))
    assert work.work("K3", p3)["flops"] == 4 * D * H * seen


def test_scan_and_gmm_kernels_count_their_own_work(monkeypatch):
    from repro_torch.kernels import mlstm_scan, ops

    _no_plain(monkeypatch)
    # K5 and K5-bwd
    Bz, S, Din, N = 2, 70, 24, 16
    xs = [torch.randn(Bz, S, Din, requires_grad=True),
          torch.rand(Bz, S, Din, requires_grad=True),
          -torch.rand(Din, N, requires_grad=True),
          torch.randn(Bz, S, N, requires_grad=True),
          torch.randn(Bz, S, N, requires_grad=True),
          torch.randn(Din, requires_grad=True)]

    def k5():
        y = ops.ssm_scan(*xs)
        torch.autograd.grad(y.sum(), xs)
        return y

    y, calls, _ = _kernel_calls(k5)
    el = Bz * S * Din * N
    (f, n), = calls["K5"]
    (b, nb), = calls["K5-bwd"]
    assert y.shape == (Bz, S, Din) and n == nb == 1 and f["with_ckpt"]
    assert work.work("K5", f)["flops"] == 6 * el + 3 * Bz * S * Din
    assert work.work("K5-bwd", b)["flops"] == 21 * el + 6 * Bz * S * Din
    with torch.no_grad():
        (y, st), calls, _ = _kernel_calls(
            lambda: ops.ssm_scan_with_state(*xs))
    assert st.shape == (Bz, Din, N) and calls["K5"][0][0]["with_state"]
    # K6 and K6-bwd
    B, H, S, D, DV = 1, 2, 40, 16, 24
    q, k = (torch.randn(B, H, S, D, requires_grad=True) for _ in range(2))
    v = torch.randn(B, H, S, DV, requires_grad=True)
    i, f_ = (torch.randn(B, H, S, requires_grad=True) for _ in range(2))

    def k6():
        h = ops.mlstm_scan(q, k, v, i, f_)
        torch.autograd.grad(h.sum(), (q, k, v, i, f_))
        return h

    h, calls, _ = _kernel_calls(k6)
    L = mlstm_scan.kernel_chunk(torch.float32, D, DV)
    pairs = B * H * (S // L * L * (L + 1) // 2 + (S % L) * (S % L + 1) // 2)
    rows = B * H * S
    (fw, n), = calls["K6"]
    (bw, nb), = calls["K6-bwd"]
    assert h.shape == (B, H, S, DV) and n == nb == 1
    assert work.work("K6", fw)["flops"] == \
        rows * (4 * D * DV + 3 * D) + 2 * (D + DV) * pairs
    assert work.work("K6-bwd", bw)["flops"] == \
        rows * (8 * D * DV + 8 * D) + (6 * D + 4 * DV) * pairs
    # K4 and its dX: the rows of the host sizes
    E, K, Nn = 3, 8, 12
    tok = torch.randn(10, K, requires_grad=True)
    w = torch.randn(E, K, Nn, requires_grad=True)

    def k4():
        out = ops.moe_gmm(tok, [4, 3, 2], w)
        torch.autograd.grad(out.sum(), (tok, w))
        return out

    out, calls, _ = _kernel_calls(k4)
    assert out.shape == (10, Nn)
    got = sorted((work.work("K4", p)["flops"], n) for p, n in calls["K4"])
    assert got == sorted([(2.0 * 9 * K * Nn, 1), (2.0 * 9 * Nn * K, 1)]) \
        or got == [(2.0 * 9 * K * Nn, 2)]


def test_no_counter_no_change():
    """Outside a counter a CPU call takes the plain version, as before;
    ``dry`` holds only under a counter, and never for a CUDA device."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.op_stats import OpCounter

    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    assert torch.equal(ops.flash_attention(q, k, k),
                       ref.attention(q, k, k))
    assert not work.dry(q) and work.takes_plain(q)
    with OpCounter():
        assert work.dry(q) and not work.takes_plain(q)
    assert work.counting() is None


# ---------------------------------------------------------------------------
# the fake worlds (one subprocess)
# ---------------------------------------------------------------------------
def test_make_production_mesh_shapes(world):
    assert world["single"] == [[16, 16], ["data", "model"], 256]
    assert world["multi"] == [[2, 16, 16], ["pod", "data", "model"], 512]
    assert "fake world" in world["real_refuses_fake"]
    assert "fake world" in world["fake_refuses_cuda"]


def test_all_cells_match_the_reference(world):
    """The same cells in the same order.  Each package's ``SHAPES`` is
    process global and the explorer registers derived shapes
    (``train_4k@gb2``) into it, so a test worker that ran other tests may
    hold different ones in each: the port's list comes from the fresh
    subprocess, the reference's without the derived shapes."""
    from repro.configs import all_cells as jall_cells
    from repro_torch.configs import all_cells

    want = [list(c) for c in jall_cells() if "@" not in c[1]]
    assert world["all_cells"] == want and len(want) == 40
    assert [list(c) for c in all_cells() if "@" not in c[1]] == want


def _nbytes(shape, itemsize=4):
    return int(np.prod(shape)) * itemsize


def _expected_collectives(leaves, dp, mesh, n_scalars_dp=2):
    """What the state's layouts imply for one train step of a rank, in
    the reference's operand convention (float32 master weights and
    gradients, 4 bytes an element):

      * the ZeRO-3 gather, a layer at a time: for each layer's slice of a
        stacked leaf (``blocks/``, ``enc_blocks/``), each dim split over
        mesh axes (not one the compute keeps split) gathered in turn, dim
        by dim, an all-gather's operand its input, the block gathered so
        far (a slice whose ``layers`` dim is split first gathered over
        those axes: its operand the local slice); twice for the blocks
        that remat ``full`` recomputes (``blocks/``: the encoder's are
        not rematerialised); a leaf without a ``layers`` dim once;
      * each gradient's reduction over its axes (the data axes, and
        ``model`` for a leaf the split leaves partial), in the gather's
        backward, once a slice: a reduce-scatter when exactly one dim of
        the slice is split over exactly those axes, else an all-reduce,
        each of the compute-shaped slice, so L slices make the whole
        compute-shaped gradient;
      * the scalars: the token count and the cross-entropy summed over
        the data axes (4 bytes each), and the squared norms of the
        leaves' blocks (4 bytes a leaf) over the whole mesh.

    Returns ``{kind: bytes}`` of the parameters' traffic and of the
    scalars."""
    size = lambda axes: int(np.prod([mesh[a] for a in axes]))  # noqa: E731
    gather = rs = ar = 0
    for lf in leaves:
        spec, keep = lf["spec"], set(lf["keep"])
        stacked = lf["path"].startswith(("blocks/", "enc_blocks/"))
        local = [d // size(e) for d, e in zip(lf["shape"], spec)]
        n = lf["shape"][0] if stacked else 1  # the gathers a forward
        block = local[1:] if stacked else list(local)
        dims = spec[1:] if stacked else spec
        shift = 1 if stacked else 0
        times = 2 if lf["path"].startswith("blocks/") else 1
        if stacked and size(spec[0]) > 1:
            gather += times * n * _nbytes(block)
        for d, e in enumerate(dims):
            if d + shift not in keep and size(e) > 1:
                gather += times * n * _nbytes(block)
                block[d] *= size(e)
        axes = lf["axes"]
        if size(axes) > 1:
            split = [d for d, e in enumerate(dims) if set(e) & set(axes)]
            if len(split) == 1 and set(dims[split[0]]) == set(axes) \
                    and split[0] + shift not in keep:
                rs += n * _nbytes(block)
            else:
                ar += n * _nbytes(block)
    scalars = 4 * n_scalars_dp + 4 * len(leaves)
    return {"all-gather": gather, "reduce-scatter": rs,
            "all-reduce": ar}, scalars


def test_fake_world_cells_come_out_ok_with_their_layouts_traffic(world):
    mesh = {"data": 4, "model": 4}
    for arch in ARCHS:
        cell = world["cells"][arch]
        st = cell["stats"]
        got = st["collectives"]["operand_bytes_by_kind"]
        want, scalars = _expected_collectives(cell["leaves"], cell["dp"],
                                              mesh)
        assert st["flops"] > 0 and st["temp_size_in_bytes"] > 0, arch
        assert st["record_again"] == st["flops"], arch
        assert got.get("all-gather", 0) == want["all-gather"], arch
        assert got.get("reduce-scatter", 0) == want["reduce-scatter"], arch
        if not cell["tp"]:
            # gather-and-repeat: no split compute, so every all-reduce is
            # a gradient's or a scalar's
            assert got.get("all-reduce", 0) == want["all-reduce"] + scalars
        else:
            # the split compute adds its activations' all-reduces
            assert got["all-reduce"] > want["all-reduce"] + scalars, arch
        # a model axis of 4: every family's serving cells build and count
        # on the reference's layouts; K1 a layer of the prefill (whisper's
        # encoder, decoder and cross attention), none in the decode (its
        # reads are plain); K5 a hymba layer and K6 an mLSTM layer of the
        # prefill, with their final states
        want = {"whisper-large-v3": {"K1": 6},
                "hymba-1.5b": {"K1": 2, "K5": 2},
                "xlstm-125m": {"K6": 1}}.get(arch, {"K1": 2})
        for name, got in cell["serving"].items():
            assert got["flops"] > 0 and got["collectives"] > 0
            assert got["args"] == _reference_serving_args(
                arch, name, seq=got["seq"]), (arch, name)
            calls = {k: v["calls"] for k, v in got["kernels"].items()
                     if k in ("K1", "K5", "K6")}
            assert calls == (want if name == "prefill_32k" else {}), calls


def _local_bytes(shape, spec, dtype, sizes):
    """The bytes of one rank's block of a leaf laid out by ``spec`` (a
    ``PartitionSpec``) on a mesh of ``sizes``, rounded up to the
    allocator's granule as the counter counts every storage."""
    from repro_torch.launch.op_stats import _ALLOC_ROUND

    n = int(np.dtype(dtype).itemsize)
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= d // int(np.prod([sizes[a] for a in axes]))
    return -(-n // _ALLOC_ROUND) * _ALLOC_ROUND


def _reference_serving_args(arch, shape_name, sizes=None, seq=None):
    """A rank's argument bytes of a reduced serving cell on the fake (4,
    4) mesh (or one of ``sizes``; the shape's sequence cut to ``seq``), by
    the reference's own layouts on an abstract mesh: its bf16 parameters
    by ``make_param_shardings``, the prompts by ``batch_specs``, the
    decode cache by ``cache_specs_sharding``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget_config
    from repro.configs import get_shape as jget_shape
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild_model
    from repro.parallel import sharding as jsh

    sizes = sizes or {"data": 4, "model": 4}
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    cfg, shape = jreduced(jget_config(arch)), jget_shape(shape_name)
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    plan = jsh.Plan(dp_axes=("data",), fsdp_axes=("data",), remat="full")
    model = jbuild_model(cfg)
    specs, axes = model.param_specs()
    specs = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype), specs)
    pairs = [(specs, jsh.make_param_shardings(mesh, axes, specs, plan))]
    if shape.kind == "prefill":
        batch = model.input_specs(shape)
        pairs.append((batch, jsh.batch_specs(batch, mesh, plan)))
    else:
        inputs = model.input_specs(shape)
        pairs.append((inputs["cache"], jsh.cache_specs_sharding(
            inputs["cache"], mesh, plan, shape.global_batch,
            shape.seq_len)))
        tok = {"tokens": inputs["tokens"]}
        pairs.append((tok, jsh.batch_specs(tok, mesh, plan)))
    total = 0
    for tree, shard in pairs:
        for x, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shard)):
            total += _local_bytes(x.shape, sh.spec, x.dtype, sizes)
    return total


def test_moe_decode_cell_holds_its_experts_split(world):
    """Reduced phi3.5-moe's decode cell on a fake (1, 4) world: a rank's
    arguments are its blocks by the reference's own serving layouts
    (the experts over ``model``); K4 counts a quarter of the rows (and
    FLOPs) of the same cell with the experts gathered whole; and the
    partial outputs' sum is one more all-reduce a layer."""
    from repro_torch.configs import get_config, reduced

    cells = world["moe_decode_1x4"]
    split, whole = cells["split"], cells["whole"]
    L = reduced(get_config("phi3.5-moe-42b-a6.6b")).num_layers
    assert split["args"] == _reference_serving_args(
        "phi3.5-moe-42b-a6.6b", "decode_32k", {"data": 1, "model": 4})
    assert split["K4"]["calls"] == whole["K4"]["calls"] == 3 * L
    assert split["K4"]["flops"] * 4 == whole["K4"]["flops"] > 0
    assert split["ops"]["all-reduce"] == whole["ops"]["all-reduce"] + L
    assert split["temp"] < whole["temp"]


def test_production_serving_cells_split_or_refused(world):
    """On 16×16 and 2×16×16: the 40 prefill and decode cells of every
    family at ``prefill_32k`` and ``decode_32k`` build; the 4
    ``long_500k`` cells of hymba and the xLSTM are refused, naming the
    ROADMAP entry."""
    cells = world["serving_cells"]
    assert len(cells) == 44
    ok = {k for k, v in cells.items() if v == "ok"}
    refused = {k: v for k, v in cells.items() if v != "ok"}
    assert len(ok) == 40 and len(refused) == 4, sorted(refused)
    for key, why in refused.items():
        arch, shape, _ = key.split("|")
        assert arch in ("hymba-1.5b", "xlstm-125m"), key
        assert shape == "long_500k", key
        assert "sharded serving cells" in why, (key, why)
    for arch in ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                 "phi-3-vision-4.2b", "whisper-large-v3", "hymba-1.5b",
                 "xlstm-125m"):
        assert sum(k.startswith(arch + "|") for k in ok) == 4, arch


def test_fake_world_kernels_count_once_a_call(world):
    """Each kernel's calls on the main path and their FLOPs from the
    cell's shapes (remat full: a layer's forward runs twice)."""
    from repro_torch.configs import get_config, reduced

    cells = world["cells"]
    b = BATCH // 4  # the data axis is 4
    # qwen2: heads split over model (4 heads over 4 ranks, KV held whole)
    k = cells["qwen2-1.5b"]["stats"]["hlo_stats"]["kernels"]
    cfg = reduced(get_config("qwen2-1.5b"))
    L, D = cfg.num_layers, cfg.head_dim
    pairs = b * 1 * work.attention_pairs(SEQ, SEQ, True, 0, 0)
    assert k["K1"] == {"calls": 2 * L, "flops": 2 * L * 4 * D * pairs,
                       "bytes": k["K1"]["bytes"]}
    assert k["K1-bwd"]["calls"] == L
    assert k["K1-bwd"]["flops"] == L * 10 * D * pairs
    # phi3.5-moe: three expert products a layer, forward, recomputed, dX
    k = cells["phi3.5-moe-42b-a6.6b"]["stats"]["hlo_stats"]["kernels"]
    mcfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    assert k["K4"]["calls"] == 9 * mcfg.num_layers
    assert k["K4"]["flops"] % (2 * mcfg.d_model * mcfg.d_ff) == 0
    # hymba: K5 a layer (twice) and K5-bwd once, over the whole batch shard
    k = cells["hymba-1.5b"]["stats"]["hlo_stats"]["kernels"]
    hcfg = reduced(get_config("hymba-1.5b"))
    assert k["K5"]["calls"] == 2 * hcfg.num_layers
    assert k["K5-bwd"]["calls"] == hcfg.num_layers
    assert k["K1"]["calls"] == 2 * hcfg.num_layers
    # xlstm: one mLSTM and one sLSTM block; K6 on the mLSTM block only
    k = cells["xlstm-125m"]["stats"]["hlo_stats"]["kernels"]
    assert (k["K6"]["calls"], k["K6-bwd"]["calls"]) == (2, 1)
    for arch in ("whisper-large-v3", "phi-3-vision-4.2b"):
        k = cells[arch]["stats"]["hlo_stats"]["kernels"]
        assert k["K1-bwd"]["calls"] > 0 and k["K1"]["calls"] > 0, arch


def test_reduced_qwen2_flops_against_reference(world):
    """The probe's cell: reduced qwen2-1.5b, seq 64, batch 4, remat none,
    on one device.  The reference's ``analyze_hlo`` counts attention as
    XLA runs it, dense: QKᵀ and PV forward and four products backward,
    each 2·B·H·S·S·D, over every (query, key) pair.  The port counts K1
    and K1-bwd by their own work, over the causal pairs S(S+1)/2 a head
    (4·D a pair forward; 10·D backward, which includes the QKᵀ that the
    flash backward recomputes: that recomputation is the 2^22 by which
    the port's plain-version count (FlopCounterMode, 167,772,160) once
    exceeded the reference's 163,577,856).  Every other FLOP is the same
    matmuls: equal at rtol 1e-6 once the attention terms are swapped."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.cells import default_plan as jdefault_plan
    from repro.launch.hlo_stats import analyze_hlo
    from repro.models import build_model as jbuild_model
    from repro.train import OptimizerConfig as JOpt
    from repro.train import make_train_artifacts as jartifacts

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    art = jartifacts(jbuild_model(jcfg), mesh,
                     jdefault_plan(jcfg, mesh, remat="none"), JOpt(),
                     JShape("t", 64, 4, "train"))
    fn = jax.jit(art.step_fn,
                 in_shardings=(art.state_shardings, art.batch_shardings),
                 out_shardings=(art.state_shardings, None))
    with mesh:
        comp = fn.lower(art.state_specs, art.batch_input_specs).compile()
    ref = analyze_hlo(comp.as_text())["flops"]

    B, S, H, D, L = 4, 64, jcfg.num_heads, jcfg.head_dim, jcfg.num_layers
    ref_attn = L * 6 * 2 * B * H * S * S * D
    causal = B * H * S * (S + 1) // 2
    port_attn = L * (4 + 10) * D * causal
    one = world["one"]
    kernels = one["hlo_stats"]["kernels"]
    assert kernels["K1"]["flops"] + kernels["K1-bwd"]["flops"] == port_attn
    assert one["collectives"]["total_ops"] == 0
    assert one["flops"] - port_attn == pytest.approx(ref - ref_attn,
                                                     rel=1e-6)
    assert ref == 163_577_856.0
    assert one["flops"] - port_attn + (L * 7 * 2 * B * H * S * S * D) \
        == 167_772_160.0  # the plain versions' count (one recomputation)
    # a serving cell on a model axis of 1: K1 once a layer
    assert world["prefill_one"]["K1"]["calls"] == L


def test_dryrun_cli_and_reanalyze(world):
    before, after = world["cli"]["before"], world["cli"]["after"]
    key = "baseline|qwen2-1.5b|train_4k|16x16"
    rec = before[key]
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["kind"] == "train"
    for k in ("flops", "bytes_accessed", "argument_size_in_bytes",
              "temp_size_in_bytes", "output_size_in_bytes", "collectives",
              "hlo_stats"):
        assert k in rec, k
    assert rec["collectives"]["total_ops"] > 0
    for shp in ("prefill_32k", "decode_32k"):
        served = before[f"baseline|qwen2-1.5b|{shp}|16x16"]
        assert served["ok"] and served["kind"] == shp.split("_")[0]
        assert served["flops"] > 0 and served["collectives"]["total_ops"] > 0
    served = before["baseline|hymba-1.5b|decode_32k|16x16"]
    assert served["ok"] and served["kind"] == "decode"
    assert served["flops"] > 0 and served["collectives"]["total_ops"] > 0
    bad = before["baseline|hymba-1.5b|long_500k|16x16"]
    assert not bad["ok"] and "sharded serving cells" in bad["error"]
    assert before["_skips"] and all(s["shape"] == "long_500k"
                                    for s in before["_skips"])
    assert world["cli"]["records"] == [
        "baseline__hymba-1.5b__decode_32k__16x16.ops.json.gz"] + [
        f"baseline__qwen2-1.5b__{shp}__16x16.ops.json.gz"
        for shp in ("decode_32k", "prefill_32k", "train_4k")]
    assert after[key]["hlo_stats"] == rec["hlo_stats"]
    assert after[key]["flops"] == rec["flops"]


# ---------------------------------------------------------------------------
# calibration and the hill-climb
# ---------------------------------------------------------------------------
def test_sample_from_stats_matches_sample_from_hlo():
    from repro.core.calibrate import sample_from_hlo
    from repro_torch.core.calibrate import sample_from_stats

    stats = {"flops": 3.5e14, "hbm_bytes": 2.25e12,
             "total_collective_bytes": 7.5e10}
    a = sample_from_hlo(stats, "v5e", "train", 1.25, source="s", weight=2.0)
    b = sample_from_stats(stats, "v5e", "train", 1.25, source="s",
                          weight=2.0)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_roofline_terms_on_the_card_and_a_tpu():
    from repro_torch.core.catalog import CHIPS, H100
    from repro_torch.launch.op_stats import roofline_terms

    stats = {"flops": 989.4e12, "hbm_bytes": 3.35e12,
             "total_collective_bytes": 450e9}
    t = roofline_terms(stats, "h100")
    assert t == pytest.approx({"compute_s": 1.0, "memory_s": 1.0,
                               "collective_s": 450e9 / H100.ici_bw})
    v = roofline_terms(stats, "v5e")
    assert v["compute_s"] == 989.4e12 / CHIPS["v5e"].peak_bf16_flops


def test_refine_plan_history_matches_the_reference():
    from repro_torch.launch.hillclimb import refine_plan

    saved = os.environ.get("XLA_FLAGS")
    try:  # the reference's dry-run module sets XLA_FLAGS on import
        from repro.launch.hillclimb import refine_plan as jrefine_plan
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    want = jrefine_plan("qwen2-1.5b", "train_4k", "v4-256")[2]
    got = refine_plan("qwen2-1.5b", "train_4k", "v4-256")[2]
    assert got == want and [h["move"] for h in got] == [
        "start", "accept", "accept"]
