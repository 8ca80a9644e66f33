"""The port's workflow specs against the reference's, on the CPU: every
registry template serializes to the reference's spec byte for byte
(``tests/golden/train-qwen2-1.5b.spec.json`` among them), each package
reads the other's specs and packages into the same graph, the pack /
unpack round trip holds, and the CLI's ``pack``, ``unpack`` and ``run
<packed spec>`` and ``register_from_spec`` work."""
import json
import os

import pytest

from repro.core import REGISTRY as JREGISTRY
from repro.core import spec as jspec
from repro.core import workflow as jworkflow
from repro_torch.core import REGISTRY, WorkflowRegistry, compile_template
from repro_torch.core.spec import (DeclaredStage, SpecError, dump_spec,
                                   dumps_spec, from_spec, load_spec,
                                   pack_template, spec_for_template,
                                   template_from_spec, template_to_spec,
                                   unpack_package, validate_spec)
from repro_torch.launch.cli import build_parser

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "train-qwen2-1.5b.spec.json")
TEMPLATES = sorted({n for n, _, _ in JREGISTRY.list()})


def _structure(g):
    return {"name": g.name, "order": g.topo_order(), "stages": [
        (n, list(g.deps(n)), type(s).__name__, list(s.inputs),
         list(s.outputs), s.placement_key, s.cacheable, list(s.cache_params))
        for n, s in g.stages.items()]}


def test_golden_spec_matches():
    with open(GOLDEN, encoding="utf-8") as f:
        on_disk = f.read()
    assert dumps_spec(spec_for_template(REGISTRY.get("train-qwen2-1.5b"))) \
        == on_disk


@pytest.mark.parametrize("with_eval", [False, True])
@pytest.mark.parametrize("name", TEMPLATES)
def test_template_specs_equal_the_reference_s(name, with_eval):
    want = jspec.spec_for_template(JREGISTRY.get(name), with_eval=with_eval)
    got = spec_for_template(REGISTRY.get(name), with_eval=with_eval)
    assert dumps_spec(got) == jspec.dumps_spec(want)
    # each package reads the other's spec into its own executable graph
    g = from_spec(json.loads(jspec.dumps_spec(want)))
    assert _structure(g) == _structure(compile_template(
        REGISTRY.get(name), with_eval=with_eval))
    assert not any(isinstance(s, DeclaredStage) for s in g.stages.values())
    jg = jspec.from_spec(json.loads(dumps_spec(got)))
    assert jg.topo_order() == g.topo_order()


@pytest.mark.parametrize("name", ["train-qwen2-1.5b", "serve-qwen2-1.5b"])
def test_pack_unpack_round_trip(name, tmp_path):
    t = REGISTRY.get(name)
    doc = pack_template(t, params={"steps_override": 5})
    assert validate_spec(doc) == []
    assert dumps_spec(doc) == jspec.dumps_spec(jspec.pack_template(
        JREGISTRY.get(name), params={"steps_override": 5}))
    t2, wf_doc, params = unpack_package(doc)
    assert t2 == t and params == {"steps_override": 5}
    assert _structure(from_spec(wf_doc)) == _structure(compile_template(t))
    assert template_from_spec(template_to_spec(t)) == t
    path = str(tmp_path / "artifact.pack.json")
    dump_spec(doc, path)
    assert load_spec(path) == doc
    # the reference's own package registers here
    reg = WorkflowRegistry()
    jpath = str(tmp_path / "ref.pack.json")
    jspec.dump_spec(jspec.pack_template(JREGISTRY.get(name)), jpath)
    assert reg.register_from_spec(jpath) == t
    with pytest.raises(SpecError, match="invalid package"):
        reg.register_from_spec({})


def test_cli_pack_unpack_and_run_a_packed_spec(tmp_path, capsys):
    pack = str(tmp_path / "wf.pack.json")

    def cli(*argv):
        args = build_parser().parse_args(list(argv))
        args.fn(args)
        return capsys.readouterr().out

    assert "packed train-qwen2-1.5b" in cli(
        "pack", "train-qwen2-1.5b", "-o", pack, "--param", "steps_override=4")
    assert '"steps_override": 4' in cli("unpack", pack, "--out-dir",
                                         str(tmp_path))
    wf = json.loads((tmp_path / "train-qwen2-1.5b.workflow.json").read_text())
    assert wf["kind"] == "workflow"
    out = cli("run", pack, "--device", "cpu", "--runs-dir",
              str(tmp_path / "runs"), "--no-cache")
    assert "ok=True" in out and "check loss_finite          PASS" in out
    runs = os.listdir(tmp_path / "runs")
    (metrics,) = [tmp_path / "runs" / r / "metrics.jsonl" for r in runs]
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert len([r for r in rows if "loss" in r]) == 4  # the packed param
    # a workflow-kind spec carries no template: `run` refuses it
    with pytest.raises(SpecError, match="carry no template"):
        cli("run", str(tmp_path / "train-qwen2-1.5b.workflow.json"),
            "--device", "cpu", "--runs-dir", str(tmp_path / "runs"))


def test_reference_registry_and_port_registry_list_the_same_templates():
    assert REGISTRY.list() == jworkflow.REGISTRY.list()
