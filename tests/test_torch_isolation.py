"""The PyTorch port stands alone: it imports neither JAX nor the
reference package, runs on the card unless asked for the CPU, and never
answers a CUDA call with its plain version."""
import ast
import os
import pathlib
import subprocess
import sys
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (build, flash_attention, flash_attention_bwd,
                                 mlstm_scan, ops, paged_attention,
                                 paged_attention_mq, ssm_scan)
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_cover_the_control_plane():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"ft/failures.py", "core/workflow.py", "core/stages.py",
            "core/graph.py", "core/provenance.py", "core/envelope.py",
            "launch/cli.py", "core/registry.py", "core/explore.py",
            "core/check.py", "core/spec.py", "core/runqueue.py"} <= names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.models.recurrent, "
            "repro_torch.kernels.mlstm_scan, repro_torch.kernels.ssm_scan, "
            "repro_torch.core.workflow, repro_torch.core.stages, "
            "repro_torch.core.registry, repro_torch.core.explore, "
            "repro_torch.core.check, repro_torch.core.spec, "
            "repro_torch.core.runqueue, repro_torch.launch.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_planning_commands_load_no_jax(tmp_path):
    """``explore``, ``calibrate``, ``check`` and ``pack`` (and ``plan``
    for the card) in a fresh process that loads no ``repro`` and no
    ``jax``."""
    script = (
        "import runpy, sys\n"
        "def cli(*argv):\n"
        "    sys.argv = ['cli', *argv]\n"
        "    runpy.run_module('repro_torch.launch.cli', run_name='__main__')\n"
        "cli('plan', '--arch', 'qwen2-1.5b', '--shape', 'train_4k', "
        "'--chip', 'h100')\n"
        "cli('explore', '--arch', 'qwen2-1.5b', '--chip', 'h100', "
        "'--chips', '1,8', '--global-batch', '2', '--runs-dir', 'runs')\n"
        "cli('calibrate', '--store', 'cal.json', '--runs-dir', 'runs')\n"
        "cli('check', 'train-qwen2-1.5b')\n"
        "cli('pack', 'train-qwen2-1.5b', '-o', 'wf.pack.json')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('loaded:', bad)\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    text = out.stdout
    assert "loaded: []" in text
    assert "h100-8" in text and "frontier has" in text
    assert "harvested 0 samples" in text and "0 error(s)" in text
    assert (tmp_path / "wf.pack.json").exists()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = reduced(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    assert build_model(cfg, device="cpu").device.type == "cpu"
    # the train entry point: --device defaults to cuda and raises here
    with mock.patch("sys.argv", ["train", "--steps", "1"]), \
            pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main()
    for arch in ("xlstm-125m", "hymba-1.5b"):
        argv = ["train", "--arch", arch, "--steps", "1"]
        with mock.patch("sys.argv", argv), \
                pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main()


def test_cuda_entries_never_return_the_plain_version(tmp_path, monkeypatch):
    """The CUDA entry points refuse CPU tensors instead of computing the
    plain result, and the build refuses to run without nvcc.  The build
    looks in an empty directory of the test's own, so a library that a
    card's run left under ``build/`` cannot stand in for the build."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)
    counters = (flash_attention, flash_attention_bwd, paged_attention,
                paged_attention_mq, mlstm_scan)
    before = [m.launches for m in counters]
    before.append(mlstm_scan.bwd_launches)
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention.flash_attention_cuda(q, k, k, with_lse=True)
    lse = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, k, k, q, lse, q)
    pool = torch.zeros(2, 3, 16, 64)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_attention.paged_attention_cuda(q[:, :1], pool, pool, table, lens)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_attention_mq.paged_attention_mq_cuda(q, pool, pool, table, lens)
    g = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mlstm_scan.mlstm_scan_cuda(q, q, q, g, g)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mlstm_scan.mlstm_scan_cuda(q, q, q, g, g, with_stats=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mlstm_scan.mlstm_scan_bwd_cuda(q, q, q, g, g, q, g, g, q)
    assert [m.launches for m in counters] + [mlstm_scan.bwd_launches] \
        == before
    try:
        build.find_nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library()
    else:
        pytest.skip("nvcc is installed here")


def test_ssm_cuda_entries_never_return_the_plain_version():
    """K5's and K5-bwd's CUDA entry points refuse CPU tensors instead of
    computing the plain result; the CPU path takes the plain pair and
    launches nothing."""
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches)
    x = torch.zeros(1, 40, 24)
    A, D = -torch.ones(24, 16), torch.ones(24)
    Bm = torch.zeros(1, 40, 16)
    ckpt = torch.zeros(2, 1, 24, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssm_scan.ssm_scan_cuda(x, x, A, Bm, Bm, D)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssm_scan.ssm_scan_cuda(x, x, A, Bm, Bm, D, with_ckpt=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssm_scan.ssm_scan_bwd_cuda(x, x, A, Bm, Bm, D, ckpt, x)
    y = ops.ssm_scan(x, x + 0.1, A, Bm, Bm, D)
    assert y.shape == x.shape
    assert (ssm_scan.launches, ssm_scan.bwd_launches) == n0
