"""The port's control plane and canonical workflows against the
reference, on the CPU.

Both packages compile, plan and run the same templates in one process;
the port's stages run on CPU tensors (the kernels' plain versions).
Weights are bridged: the port's single init functions
(``stages.init_train_state_for``, ``stages.init_serve_params``) are
swapped for ones that map the reference's own init through numpy, so
both runs start from the same state.  Tolerances, each with its reason:

  * graphs, plan choices' slices, meshes and geometries: equal; the
    choices' estimates within rtol 1e-12 (the same float64 arithmetic);
  * ``train-qwen2-1.5b`` at 6 steps as the template runs it (bf16
    compute): loss and lr within rtol 1e-4 at every step (the curve
    tolerance of PERF.md §6); grad_norm within rtol 2e-3 (gradients of
    bf16 products rounded at other points by the two backward passes
    move the norm past 1e-4; bf16's epsilon is 7.8e-3); the same checks,
    verdicts and event kinds;
  * the same run in float32 compute (both packages' data stages patched
    to cast the reduced config): loss, grad_norm and lr within rtol 1e-4;
  * ``serve-qwen2-1.5b`` fused, paged, and paged with spec_k 4: the same
    completions, token for token;
  * a failure at step 3 and a resume of a run cut at step 3: final states
    bit-identical to an uninterrupted run of the port.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import planner as jplanner
from repro.core import stages as jstages
from repro.core import workflow as jworkflow
from repro.core.intent import ResourceIntent as JIntent
from repro.core.provenance import ProvenanceStore as JStore
from repro.core.stagecache import StageCache as JCache
from repro.models import build_model as jbuild_model
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro_torch.bridge import from_jax_params, from_jax_train_state
from repro_torch.core import planner, stages, workflow
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.provenance import ProvenanceStore
from repro_torch.ft.failures import FailureSchedule
from repro_torch.launch import cli
from repro_torch.tree import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = [name for name, _, _ in jworkflow.REGISTRY.list()]
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(cfg):
    return JModelConfig(**dataclasses.asdict(cfg))


def bridged_train_state(model, seed, opt_cfg, rt_plan):
    """The reference's initial train state, bridged onto the port."""
    jstate = jinit_train_state(
        jbuild_model(_jcfg(model.cfg)), jax.random.PRNGKey(seed),
        JOptimizerConfig(**dataclasses.asdict(opt_cfg)))
    return from_jax_train_state(jax.tree.map(np.asarray, jstate), model.cfg,
                                model.device)


def bridged_serve_params(model, seed):
    params, _ = jbuild_model(_jcfg(model.cfg)).init(jax.random.PRNGKey(seed))
    return from_jax_params(jax.tree.map(np.asarray, params), model.cfg,
                           model.device)


def _float32_workload(original):
    def reduced_workload(*a, **kw):
        full_cfg, cfg, shape = original(*a, **kw)
        return full_cfg, dataclasses.replace(cfg, dtype="float32"), shape
    return reduced_workload


def _jintent(intent):
    return JIntent(**dataclasses.asdict(intent))


# ---------------------------------------------------------------------------
# graphs and plans
def _graph_doc(g):
    return {"order": g.topo_order(),
            "stages": {n: (type(s).__name__, tuple(g.deps(n)),
                           tuple(s.inputs), tuple(s.outputs))
                       for n, s in g.stages.items()}}


@pytest.mark.parametrize("with_eval", [False, True])
@pytest.mark.parametrize("name", TEMPLATES)
def test_compile_template_matches_reference(name, with_eval):
    want = jworkflow.compile_template(jworkflow.REGISTRY.get(name),
                                      with_eval=with_eval)
    got = workflow.compile_template(workflow.REGISTRY.get(name),
                                    with_eval=with_eval)
    assert _graph_doc(got) == _graph_doc(want)


def _same_choice(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert b.slice.name == a.slice.name
    assert b.mesh_shape == a.mesh_shape and b.mesh_axes == a.mesh_axes
    assert dataclasses.asdict(b.geometry) == dataclasses.asdict(a.geometry)
    ea, eb = dataclasses.asdict(a.est), dataclasses.asdict(b.est)
    assert ea.keys() == eb.keys()
    for k, v in ea.items():
        if isinstance(v, float):
            np.testing.assert_allclose(eb[k], v, rtol=1e-12, err_msg=k)
        else:
            assert eb[k] == v, k


@pytest.mark.parametrize("name", TEMPLATES)
def test_plan_stages_match_reference(name):
    intent = workflow.REGISTRY.get(name).default_intent()
    intents = {"__main__": intent, "data": intent.with_goal("quick_test")}
    want = jplanner.plan_stages({k: _jintent(v) for k, v in intents.items()})
    got = planner.plan_stages(intents)
    assert got.keys() == want.keys()
    for k in want:
        _same_choice(want[k], got[k])
    main = got["__main__"]
    rt, jrt = planner.to_runtime_plan(main), jplanner.to_runtime_plan(
        want["__main__"])
    assert (rt.remat, rt.microbatch) == (jrt.remat, jrt.microbatch)


@pytest.mark.parametrize("name", TEMPLATES)
def test_every_template_runs_at_reduced_scale(name, tmp_path):
    """Each of the registry's templates (the serve template and the ten
    train templates, the encoder-decoder's and the VLM's among them)
    runs through the port's ``run_workflow`` on the CPU at its reduced
    scale, with every check passing."""
    res = workflow.run_workflow(workflow.REGISTRY.get(name),
                                ProvenanceStore(str(tmp_path)),
                                steps_override=STEPS, device="cpu")
    assert res.ok and res.checks, res.checks
    assert all(v[0] for v in res.checks.values()), res.checks


@pytest.mark.parametrize("goal", ["production", "exploration", "quick_test"])
def test_plan_goals_match_reference(goal):
    intent = ResourceIntent(arch="qwen2-1.5b", shape="train_4k", goal=goal)
    want, got = jplanner.plan(_jintent(intent)), planner.plan(intent)
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        _same_choice(a, b)
        rt, jrt = planner.to_runtime_plan(b), jplanner.to_runtime_plan(a)
        assert (rt.remat, rt.microbatch) == (jrt.remat, jrt.microbatch)


# ---------------------------------------------------------------------------
# the train workflow
def _run_pair(tmp, compute_f32: bool):
    patches = [mock.patch.object(stages, "init_train_state_for",
                                 bridged_train_state)]
    if compute_f32:
        patches += [mock.patch.object(m, "_reduced_workload",
                                      _float32_workload(m._reduced_workload))
                    for m in (jstages, stages)]
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        want = jworkflow.run_workflow(
            jworkflow.REGISTRY.get("train-qwen2-1.5b"), JStore(f"{tmp}/ref"),
            steps_override=STEPS)
        got = workflow.run_workflow(
            workflow.REGISTRY.get("train-qwen2-1.5b"),
            ProvenanceStore(f"{tmp}/port"), steps_override=STEPS,
            device="cpu")
    return want, got


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    return _run_pair(str(tmp_path_factory.mktemp("train")), False)


def _curves(res):
    rows = [r for r in res.record.metrics() if "loss" in r]
    return {k: np.array([r[k] for r in rows])
            for k in ("step", "loss", "grad_norm", "lr")}


def test_train_workflow_curve_matches_reference(train_runs):
    want, got = (_curves(r) for r in train_runs)
    assert list(got["step"]) == list(want["step"]) == list(range(STEPS))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=2e-3)


def test_train_workflow_float32_curve_matches_reference(tmp_path):
    want, got = (_curves(r) for r in _run_pair(str(tmp_path), True))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# the train graph's stage that launches beside the plan stage (no edge
# to it)
BESIDE_PLAN = ("data",)


def _kinds_by_stage(record, drop=("environment",)):
    """Each stage's event kinds, sorted: the plan stage logs the data
    stage's plan while the data stage runs, in either order.

    ``placement`` is left out for a stage launched beside the plan stage
    (``BESIDE_PLAN``): the scheduler binds a stage to a placement at
    launch, best effort, from the ``stage_plans`` the plan stage has
    written by then (``StageGraph._resolve_placement``, the reference's
    documented behaviour), so whether the data stage gets one is a race
    between the two stages in either package.  The stages that depend on
    the plan stage are compared whole: train is bound to the main plan
    (one ``placement``, asserted beside this comparison), validate and
    visualize have no plan of their own and get none."""
    out = {}
    for e in record.events():
        if e["kind"] in drop:
            continue
        if e["kind"] == "placement" and e.get("stage") in BESIDE_PLAN:
            continue
        out.setdefault(e.get("stage", ""), []).append(e["kind"])
    return {k: sorted(v) for k, v in out.items()}


def test_train_workflow_checks_and_events_match_reference(train_runs):
    want, got = train_runs
    assert got.ok and want.ok
    assert {k: v[0] for k, v in got.checks.items()} \
        == {k: v[0] for k, v in want.checks.items()}
    assert _kinds_by_stage(got.record) == _kinds_by_stage(want.record)
    for res in (got, want):
        kinds = _kinds_by_stage(res.record)
        assert kinds["train"].count("placement") == 1, kinds
        assert "placement" not in kinds["validate"] + kinds["visualize"]
    # plan and data run concurrently: results arrive in either order
    assert sorted(got.stage_results) == sorted(want.stage_results)
    env = [e for e in got.record.events() if e["kind"] == "environment"]
    assert [e["stage"] for e in env] == ["train"]
    assert env[0]["device"] == "cpu" and env[0]["backend"] in ("cpu", "cuda")
    manifest = got.record.manifest
    assert manifest["environment"]["torch_version"] == torch.__version__
    assert manifest["plan"]["slice"] == want.record.manifest["plan"]["slice"]
    # no tensor reached the record: every metric is a float
    assert all(isinstance(v, float) for r in got.record.metrics()
               for k, v in r.items() if k not in ("step", "stage"))


# ---------------------------------------------------------------------------
# the serve workflow
@pytest.mark.parametrize("knobs", [
    dict(serve_engine="fused"), dict(serve_engine="paged"),
    dict(serve_engine="paged", serve_spec_k=4)], ids=["fused", "paged",
                                                      "paged-spec4"])
def test_serve_workflow_tokens_match_reference(tmp_path, knobs):
    want = jworkflow.run_workflow(jworkflow.REGISTRY.get("serve-qwen2-1.5b"),
                                  JStore(str(tmp_path / "ref")), **knobs)
    with mock.patch.object(stages, "init_serve_params", bridged_serve_params):
        got = workflow.run_workflow(workflow.REGISTRY.get("serve-qwen2-1.5b"),
                                    ProvenanceStore(str(tmp_path / "port")),
                                    device="cpu", **knobs)
    tokens = {c.uid: list(c.tokens) for c in got.final_state}
    assert tokens == {c.uid: list(c.tokens) for c in want.final_state}
    assert len(tokens) == 8 and got.ok and want.ok
    row = [r for r in got.record.metrics() if r.get("stage") == "serve"][0]
    assert row["engine"] == knobs["serve_engine"] and row["requests"] == 8.0


# ---------------------------------------------------------------------------
# failure and resume: bit-identical to an uninterrupted run
class _Cut(FailureSchedule):
    """Kills the train stage at ``fail_at_steps`` with an error that is
    not retried, as a crash would."""

    def check(self, step):
        if step in self.fail_at_steps:
            raise RuntimeError(f"cut at step {step}")


def _template():
    # checkpoint every 2 steps: a cut at step 3 restores step 1
    return workflow.REGISTRY.get("train-qwen2-1.5b").with_overrides(
        checkpoint_every=2)


def _assert_bit_identical(a, b):
    fa, fb = dict(flatten(a)), dict(flatten(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    store = ProvenanceStore(str(tmp_path_factory.mktemp("whole")))
    return workflow.run_workflow(_template(), store, steps_override=STEPS,
                                 device="cpu")


def test_failure_at_step_3_is_bit_identical(tmp_path, uninterrupted):
    res = workflow.run_workflow(_template(), ProvenanceStore(str(tmp_path)),
                                steps_override=STEPS, device="cpu",
                                failures=FailureSchedule((3,)))
    kinds = [e["kind"] for e in res.record.events()]
    assert "failure" in kinds and "restore" in kinds and res.ok
    restore = [e for e in res.record.events() if e["kind"] == "restore"]
    assert restore[0]["step"] == 1
    _assert_bit_identical(res.final_state, uninterrupted.final_state)


def test_resume_of_a_run_cut_at_step_3_is_bit_identical(tmp_path,
                                                        uninterrupted):
    store = ProvenanceStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="cut at step 3"):
        workflow.run_workflow(_template(), store, steps_override=STEPS,
                              device="cpu", failures=_Cut((3,)))
    (run_id,) = store.list_runs()
    res = workflow.run_workflow(_template(), store, steps_override=STEPS,
                                device="cpu", resume=run_id)
    assert res.ok
    assert res.stage_results["plan"].resumed
    assert res.stage_results["data"].resumed
    assert not res.stage_results["train"].skipped
    _assert_bit_identical(res.final_state, uninterrupted.final_state)


# ---------------------------------------------------------------------------
# the stage cache across packages, and the CLI
def test_cli_runs_and_never_reads_the_reference_cache(tmp_path):
    cache, runs = str(tmp_path / "cache"), str(tmp_path / "runs")
    jres = jworkflow.run_workflow(jworkflow.REGISTRY.get("train-qwen2-1.5b"),
                                  JStore(str(tmp_path / "ref")),
                                  stages=["data"], cache=JCache(cache))
    assert not jres.stage_results["data"].cached
    assert len(os.listdir(cache)) == 2  # one entry: payload + sidecar
    script = (
        "import runpy, sys\n"
        "def cli(*argv):\n"
        "    sys.argv = ['cli', *argv]\n"
        "    runpy.run_module('repro_torch.launch.cli', run_name='__main__')\n"
        f"cli('templates'); cli('graph', 'train-qwen2-1.5b')\n"
        f"cli('plan', '--arch', 'qwen2-1.5b', '--shape', 'train_4k')\n"
        f"cli('run', 'train-qwen2-1.5b', '--device', 'cpu', '--steps', '4',"
        f" '--runs-dir', {runs!r}, '--cache-dir', {cache!r})\n"
        f"cli('run', 'train-qwen2-1.5b', '--device', 'cpu', '--stage',"
        f" 'data', '--runs-dir', {runs!r}, '--cache-dir', {cache!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('loaded:', bad)\n")
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert "loaded: []" in text
    assert "train-qwen2-1.5b" in text and "serve-qwen2-1.5b" in text
    assert "top 5 plans (production)" in text
    assert "visualize" in text  # the graph
    runs_out = text.split("run train-qwen2-1.5b-")
    assert len(runs_out) == 3 and "ok=True" in runs_out[1]
    # the port's first run missed the reference's entry, its second hit
    # its own
    assert "stage data             ok" in runs_out[1]
    assert "stage data             hit" in runs_out[2]
    assert "check loss_finite          PASS" in runs_out[1]


def test_cli_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    argv = ["cli", "run", "train-qwen2-1.5b", "--steps", "1", "--runs-dir",
            str(tmp_path), "--no-cache"]
    with mock.patch("sys.argv", argv), \
            pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main()
    assert os.listdir(tmp_path) == []  # raised before any run record
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workflow.run_workflow(workflow.REGISTRY.get("serve-qwen2-1.5b"),
                              ProvenanceStore(str(tmp_path)))


@pytest.mark.parametrize("argv", [
    ["explore", "--arch", "glm4-9b"], ["calibrate"],
    ["check", "train-qwen2-1.5b"],
    ["pack", "train-qwen2-1.5b"], ["unpack", "train-qwen2-1.5b.pack.json"],
    ["run", "train-qwen2-1.5b.pack.json", "--device", "cpu"],
    ["run", "train-qwen2-1.5b", "--check", "--device", "cpu"]])
def test_cli_commands_not_ported_yet_raise(tmp_path, argv, monkeypatch,
                                           capsys):
    """The commands that raised ``NotImplementedError`` until the control
    plane's planning side was ported: each now runs (in ``tmp_path``,
    from a packed artifact where it needs one) and says what it did."""
    monkeypatch.chdir(tmp_path)
    store = str(tmp_path / "cal.json")
    if argv[0] in ("unpack", "run") and argv[1].endswith(".pack.json"):
        with mock.patch("sys.argv", ["cli", "pack", "train-qwen2-1.5b",
                                     "--param", "steps_override=4"]):
            cli.main()
    extra = {"run": ["--runs-dir", str(tmp_path / "runs"), "--steps", "4",
                     "--no-cache"],
             "explore": ["--runs-dir", str(tmp_path / "runs")],
             "calibrate": ["--store", store, "--runs-dir",
                           str(tmp_path / "runs")]}.get(argv[0], [])
    capsys.readouterr()
    with mock.patch("sys.argv", ["cli", *argv, *extra]):
        cli.main()
    out = capsys.readouterr().out
    want = {"explore": "frontier has", "calibrate": "harvested 0 samples",
            "check": "0 error(s)", "pack": "packed train-qwen2-1.5b",
            "unpack": "workflow ->", "run": "ok="}[argv[0]]
    assert want in out, out


def test_process_executor_keeps_tensors_out_of_children(tmp_path):
    """``--executor processes`` sends only the data stage to a child (the
    eval stage runs the model, so it stays inline) and the run matches
    the threaded run's losses."""
    t = workflow.REGISTRY.get("train-qwen2-1.5b")
    res = workflow.run_workflow(t, ProvenanceStore(str(tmp_path)),
                                steps_override=4, with_eval=True,
                                executor="processes", workers=1,
                                device="cpu")
    assert res.ok
    workers = {e["stage"]: e["worker"] for e in res.record.events()
               if e["kind"] == "stage_worker"}
    assert workers["data"].startswith("pid:")
    assert workers["train"] == workers["eval"] == "inline"
    assert not stages.EvalStage.process_safe
    manifest = json.load(open(os.path.join(res.record.dir,
                                           "stage_manifest.json")))
    assert manifest["train"]["payload"] is False  # the state stays on disk
