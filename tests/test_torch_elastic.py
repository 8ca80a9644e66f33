"""Elastic restore of the port on spawned gloo worlds on the CPU.

A sharded state saved on a (2, 2) ("data", "model") world is restored
onto a (2, 1) world and onto one process with no other rank
(``elastic_restart``), and the train stage's resume onto a placement's
mesh logs the reference stage's ``reshard`` event.  The model is reduced
qwen2-1.5b in float32 with ``d_ff`` 8192, whose MLP weights FSDP splits
over "data" (and "model"), so the restore moves real blocks.

Tolerances, each with its reason:

  * every restored leaf, gathered whole, bit for bit the saved state
    (the checkpoint holds whole leaves; a restore only slices);
  * on one process, the step after the restore bit for bit the port's
    unsharded step from the saved state (a mesh of one rank computes
    the unsharded step);
  * the step after the restore, on (2, 1) and on one process, within
    1e-5 of each leaf's max |x| of the uninterrupted run's second step
    on (2, 2) (float32 sums over other splits of the batch; AdamW's
    ``eps`` 1e-3, as in tests/test_torch_compression.py);
  * the ``reshard`` event of a resumed ``train-qwen2-1.5b`` run: its
    stage, slice and mesh shape equal the reference's.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro.core import ProvenanceStore as JStore
from repro.core import workflow as jworkflow
from repro.ft.failures import FailureSchedule as JFailureSchedule
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.core import ProvenanceStore, workflow
from repro_torch.ft import elastic_restart
from repro_torch.ft.failures import FailureSchedule
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_step)
from repro_torch.tree import flatten, tree_map
from test_torch_compression import OPT
from torch_worlds import elastic_world, run_world

OVER = {"d_ff": 8192}
PLAN = {"remat": "none"}


def _case():
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32", **OVER)
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(1)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, 256, (4, 16)).astype(np.int32))} for _ in range(2)]
    state = init_train_state(model, 0, OptimizerConfig(**OPT), Plan(**PLAN))
    return model, dict(arch="qwen2-1.5b", over=OVER, plan=PLAN, opt=OPT,
                       state=state, batches=batches)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    model, case = _case()
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    (first, second), *_ = run_world(elastic_world, 4,
                                    tmp_path_factory.mktemp("w4"), (2, 2),
                                    case, ckpt, "save")
    return model, case, ckpt, first, second


def _assert_close(got, want):
    for (key, x), (_, y) in zip(flatten(got), flatten(want)):
        top = max(float(y.detach().float().abs().max()), 1e-30)
        np.testing.assert_allclose(x.detach().float().numpy(),
                                   y.detach().float().numpy(),
                                   atol=1e-5 * top, rtol=0, err_msg=key)


def _assert_equal(got, want):
    fa, fb = dict(flatten(got)), dict(flatten(want))
    assert fa.keys() == fb.keys()
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key


def test_restore_onto_a_world_of_two(saved, tmp_path):
    _, case, ckpt, first, second = saved
    (restored, after, step), _ = run_world(elastic_world, 2, tmp_path,
                                           (2, 1), case, ckpt, "restore")
    assert step == 0
    _assert_equal(restored, first)
    _assert_close(after, second)


def test_restore_onto_one_process(saved):
    model, case, ckpt, first, second = saved
    plan = Plan(**PLAN)
    opt = OptimizerConfig(**OPT)
    mesh = local_mesh("cpu")
    state, step = elastic_restart(Checkpointer(ckpt), case["state"], model,
                                  mesh, plan)
    assert step == 0
    _assert_equal(state, first)
    state, _ = make_train_step(model, opt, plan, mesh)(state,
                                                      case["batches"][1])
    want, _ = make_train_step(model, opt, plan)(
        tree_map(lambda x: x.clone(), first), case["batches"][1])
    _assert_equal(state, want)
    _assert_close(state, second)


class _Cut(FailureSchedule):
    """Kills the train stage at ``fail_at_steps``, as a crash would."""

    def check(self, step):
        if step in self.fail_at_steps:
            raise RuntimeError(f"cut at step {step}")


class _JCut(JFailureSchedule):
    def check(self, step):
        if step in self.fail_at_steps:
            raise RuntimeError(f"cut at step {step}")


def _wait_committed(root, run_id):
    """Wait for the cut run's last background checkpoint write to
    commit (it runs on in this process after the cut)."""
    ck = Checkpointer(os.path.join(str(root), run_id, "artifacts",
                                   "ckpt-train"))
    deadline = time.monotonic() + 60
    while ck.latest_step() is None:
        assert time.monotonic() < deadline, "no checkpoint committed"
        time.sleep(0.05)


def _reshard_events(records):
    out = []
    for rec in records:
        out += [{k: v for k, v in e.items() if k in ("kind", "stage",
                                                       "slice", "mesh_shape")}
                for e in rec.events() if e["kind"].startswith("reshard")]
    return out


def test_resumed_train_stage_reshards_as_the_reference(tmp_path):
    """A ``train-qwen2-1.5b`` run cut at step 3 and resumed: its train
    stage restores onto its placement's mesh and logs ``reshard`` (not
    ``reshard_skipped``) with the reference's stage, slice and mesh.  The
    reference's resumed run may fail after that event (ROADMAP §3: its
    resharded restore meets JAX 0.9's ``ShardingTypeError``); only its
    events are compared."""
    t = workflow.REGISTRY.get("train-qwen2-1.5b").with_overrides(
        checkpoint_every=2)
    store = ProvenanceStore(str(tmp_path / "port"))
    with pytest.raises(RuntimeError, match="cut at step 3"):
        workflow.run_workflow(t, store, steps_override=6, device="cpu",
                              failures=_Cut((3,)))
    (run_id,) = store.list_runs()
    _wait_committed(tmp_path / "port", run_id)
    res = workflow.run_workflow(t, store, steps_override=6, device="cpu",
                                resume=run_id)
    assert res.ok
    got = _reshard_events([res.record])

    jt = jworkflow.REGISTRY.get("train-qwen2-1.5b").with_overrides(
        checkpoint_every=2)
    jstore = JStore(str(tmp_path / "ref"))
    with pytest.raises(RuntimeError, match="cut at step 3"):
        jworkflow.run_workflow(jt, jstore, steps_override=6,
                               failures=_JCut((3,)))
    (jrun,) = jstore.list_runs()
    _wait_committed(tmp_path / "ref", jrun)
    try:
        jworkflow.run_workflow(jt, jstore, steps_override=6, resume=jrun)
    except Exception:  # noqa: BLE001 — the reference's fault, see above
        pass
    want = _reshard_events([jstore.load(r) for r in jstore.list_runs()])
    assert got and got == want
    assert got[0]["kind"] == "reshard"
