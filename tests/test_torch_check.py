"""The port's static workflow checker against the reference's, on the
CPU: the same diagnostics (code, severity, stage, key and message) and
the same waived ones for every file of ``tests/badspecs/``, for every
registry template's package, and for the movement-lowered graph; the
``run --check`` gate, ``check=True`` and the CLI's ``check``."""
import glob
import json
import os

import pytest

from repro.core import REGISTRY as JREGISTRY
from repro.core import check as jcheck
from repro.core import spec as jspec
from repro.core import workflow as jworkflow
from repro_torch.core import (REGISTRY, CheckError, ProvenanceStore,
                              check_spec, compile_template,
                              insert_movement_stages, pack_template,
                              run_workflow)
from repro_torch.core.check import CODES
from repro_torch.core.spec import DeclaredStage
from repro_torch.launch.cli import build_parser

HERE = os.path.dirname(__file__)
BADSPECS = sorted(glob.glob(os.path.join(HERE, "badspecs", "*.json")))
TEMPLATES = sorted({n for n, _, _ in JREGISTRY.list()})


def _doc(report):
    return json.loads(json.dumps(report.as_doc()))


def test_the_catalog_of_codes_is_the_reference_s():
    assert CODES == jcheck.CODES


@pytest.mark.parametrize("path", BADSPECS,
                         ids=[os.path.basename(p) for p in BADSPECS])
def test_badspec_findings_match_reference(path):
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    want = jcheck.check_spec(json.loads(json.dumps(doc)))
    got = check_spec(doc)
    assert _doc(got) == _doc(want)
    assert set(doc["meta"]["expect"]) <= {d.code for d in got.diagnostics}
    assert got.render() == want.render()


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_packages_check_as_the_reference(name):
    want = jcheck.check_spec(jspec.pack_template(JREGISTRY.get(name)))
    got = check_spec(pack_template(REGISTRY.get(name)))
    assert got.ok and _doc(got) == _doc(want)


def test_movement_lowering_matches_reference():
    t, jt = REGISTRY.get("train-qwen2-1.5b"), JREGISTRY.get("train-qwen2-1.5b")
    got = insert_movement_stages(compile_template(t), template=t)
    want = jcheck.insert_movement_stages(jworkflow.compile_template(jt),
                                         template=jt)
    assert list(got.stages) == list(want.stages)
    assert "move.cfg.v5p-4.v5e-128" in got.stages


def test_run_check_gate(tmp_path):
    t = REGISTRY.get("train-qwen2-1.5b")
    res = run_workflow(t, ProvenanceStore(str(tmp_path / "ok")),
                       steps_override=4, check=True, device="cpu")
    assert res.final_state is not None
    g = compile_template(t)
    g.add(DeclaredStage("orphan", inputs=("no_such_key",), outputs=()))
    with pytest.raises(CheckError) as exc:
        run_workflow(t, ProvenanceStore(str(tmp_path / "bad")), graph=g,
                     steps_override=3, check=True, device="cpu")
    assert any(d.code == "ADV001" for d in exc.value.report.diagnostics)
    assert not (tmp_path / "bad").exists() \
        or not list((tmp_path / "bad").iterdir())


def _cli(argv):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def test_cli_check(tmp_path, capsys):
    assert _cli(["check", "--all-templates"]) == 0
    assert "serve-qwen2-1.5b" in capsys.readouterr().out
    assert _cli(["check", os.path.join(HERE, "badspecs", "cycle.json")]) == 1
    assert "ADV011" in capsys.readouterr().out
    path = os.path.join(HERE, "badspecs", "missing_producer.json")
    assert _cli(["check", path, "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is False
    out = str(tmp_path / "lowered.json")
    assert _cli(["check", "train-qwen2-1.5b", "--lowered-out", out]) == 0
    capsys.readouterr()
    assert _cli(["check", out]) == 0
