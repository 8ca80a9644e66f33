"""The reference's workflow-engine cases that run no model
(``tests/test_workflow.py``: registry versioning, parameter injection,
budget, permissions, the ledger, ``stable_hash``), run against the
port's copy of the control plane, plus the port's own rules for what it
does not copy: package-scoped cache keys and calibration stores, no
device tensor in a stage payload, and the raising stand-in for a
placement's mesh."""
import json
import pickle

import pytest
import torch

from repro_torch.core import (REGISTRY, BudgetExceeded, BudgetLedger,
                              CalibrationStore, CheckError, PermissionDenied,
                              ProvenanceStore, SpecError, WorkflowRegistry,
                              WorkflowTemplate, compile_template,
                              run_workflow, stable_hash)
from repro_torch.core import calibrate
from repro_torch.core.graph import Placement
from repro_torch.core.spec import DeclaredStage
from repro_torch.core.stagecache import host_dumps


def case_registry_versioning(tmp_path):
    r = WorkflowRegistry()
    t1 = WorkflowTemplate(name="x", version="1.0.0", description="",
                          arch="qwen2-1.5b", shape="train_4k")
    t2 = WorkflowTemplate(name="x", version="1.1.0", description="",
                          arch="qwen2-1.5b", shape="train_4k")
    r.register(t1)
    r.register(t2)
    assert r.get("x").version == "1.1.0"  # latest by default
    assert r.get("x", "1.0.0").version == "1.0.0"
    with pytest.raises(ValueError, match="immutable"):
        r.register(t1)


def case_param_injection_with_overrides(tmp_path):
    t = REGISTRY.get("train-qwen2-1.5b")
    t2 = t.with_overrides(**{"optimizer.lr": 5e-4, "num_steps": 7,
                             "data.seed": 9})
    assert t2.optimizer.lr == 5e-4
    assert t2.num_steps == 7
    assert t2.data.seed == 9
    assert t.optimizer.lr != 5e-4  # original untouched


def case_budget_enforcement(tmp_path):
    store = ProvenanceStore(str(tmp_path / "runs"))
    ledger = BudgetLedger(str(tmp_path / "ledger.json"))
    ledger.create_workspace("class", admins=["prof"], members=["stu"],
                            budget_usd=1e-6)
    t = REGISTRY.get("train-qwen2-1.5b")
    with pytest.raises(BudgetExceeded):
        run_workflow(t, store, user="stu", workspace="class", ledger=ledger,
                     steps_override=5, device="cpu")
    assert store.list_runs() == []  # a denied run leaves no record


def case_permissions(tmp_path):
    ledger = BudgetLedger(str(tmp_path / "ledger.json"))
    ledger.create_workspace("lab", admins=["pi"], members=["alice"],
                            budget_usd=100.0,
                            allowed_templates=["train-qwen2-1.5b"])
    with pytest.raises(PermissionDenied):
        ledger.authorize("lab", "mallory", "train-qwen2-1.5b", 1.0)
    with pytest.raises(PermissionDenied):
        ledger.authorize("lab", "alice", "train-glm4-9b", 1.0)
    ledger.authorize("lab", "alice", "train-qwen2-1.5b", 1.0)
    with pytest.raises(PermissionDenied):
        ledger.add_member("lab", "bob", by="alice")  # not an admin
    ledger.add_member("lab", "bob", by="pi")
    ledger.authorize("lab", "bob", "train-qwen2-1.5b", 1.0)


def case_ledger_persists(tmp_path):
    path = str(tmp_path / "ledger.json")
    l1 = BudgetLedger(path)
    l1.create_workspace("w", admins=["a"], budget_usd=10.0)
    l1.charge("w", "a", 4.0)
    l2 = BudgetLedger(path)
    assert l2.get("w").spent_usd == 4.0
    with pytest.raises(BudgetExceeded):
        l2.charge("w", "a", 7.0)


def case_stable_hash_deterministic(tmp_path):
    a = {"x": 1, "y": {"z": [1, 2]}}
    b = {"y": {"z": [1, 2]}, "x": 1}
    assert stable_hash(a) == stable_hash(b)
    assert stable_hash(a) != stable_hash({"x": 2, "y": {"z": [1, 2]}})


def case_calibration_store_is_the_ports_own(tmp_path):
    path = tmp_path / "calibration.json"
    store = CalibrationStore(str(path))
    assert store.document()["samples"] == {}
    # a store the reference wrote at the same path is never read
    path.write_text(json.dumps({"version": 1, "generation": 3,
                                "samples": {"k": {}}, "cells": {}}))
    with pytest.raises(ValueError, match="package 'repro'"):
        store.document()
    assert "repro_torch" in calibrate.DEFAULT_STORE_PATH


def case_stage_payloads_hold_no_device_tensor(tmp_path):
    cpu = {"state": torch.ones(3), "n": 1}
    assert pickle.loads(host_dumps(cpu))["state"].tolist() == [1.0] * 3
    meta = torch.empty(2, device="meta")  # a tensor off the CPU
    with pytest.raises(pickle.PicklingError, match="stage payload"):
        host_dumps({"state": [meta]})


def case_unported_entries_raise(tmp_path):
    """The stand-ins that raised here for the checker and workflow specs
    are gone (both are ported, ``test_torch_check.py`` and
    ``test_torch_spec.py`` hold them against the reference): an empty
    package is refused as the reference refuses it, and ``check=True``
    gates a broken graph before any run record.  A placement's mesh
    still raises."""
    with pytest.raises(SpecError, match="invalid package"):
        REGISTRY.register_from_spec({})
    t = REGISTRY.get("train-qwen2-1.5b")
    g = compile_template(t)
    g.add(DeclaredStage("orphan", inputs=("no_such_key",), outputs=()))
    with pytest.raises(CheckError) as exc:
        run_workflow(t, ProvenanceStore(str(tmp_path)), graph=g,
                     check=True, device="cpu")
    assert any(d.code == "ADV001" for d in exc.value.report.diagnostics)
    assert not list(tmp_path.iterdir())  # no run record
    p = Placement(stage="train", slice_name="v5e-8", mesh_shape=(8, 1),
                  mesh_axes=("data", "model"), chips=8, price_per_hour=1.0)
    with pytest.raises(NotImplementedError,
                       match="parallelism and elasticity"):
        p.build_mesh()


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_plane_case(case, tmp_path):
    CASES[case](tmp_path)
