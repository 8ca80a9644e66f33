"""The PyTorch port stands alone: it imports neither JAX nor the
reference package, runs on the card unless asked for the CPU, and never
answers a CUDA call with its plain version."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (build, flash_attention, paged_attention,
                                 paged_attention_mq)
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


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = reduced(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_cuda_entries_never_return_the_plain_version():
    """The CUDA entry points refuse CPU tensors instead of computing the
    plain result, and the build refuses to run without nvcc."""
    counters = (flash_attention, paged_attention, paged_attention_mq)
    before = [m.launches for m in counters]
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention.flash_attention_cuda(q, k, k)
    pool = torch.zeros(2, 3, 16, 64)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_attention.paged_attention_cuda(q[:, :1], pool, pool, table, lens)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        paged_attention_mq.paged_attention_mq_cuda(q, pool, pool, table, lens)
    assert [m.launches for m in counters] == before
    try:
        build.find_nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library()
    else:
        pytest.skip("nvcc is installed here")
