"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together) and linked into
one shared library with a plain C interface, which is loaded with
``ctypes``.  The library lands in ``build/repro_torch/`` at the root of
the checkout, named by a digest of the sources, so an edited source
(or header) rebuilds and an unchanged one loads at once.  Only sources in the
repository are built; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Each returns a cudaError_t as int.
_SIGNATURES = {
    # q, k, v, out, lse (nullable), B, S, T, H, KH, D, scale, causal,
    # window, q_offset, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _I, _I, _I, _I, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, T, H, KH, D, scale,
    # causal, window, q_offset, dtype, stream, failed_step (host int: the
    # step that failed, STEPS)
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_F] + [_I] * 4
                                 + [_P, _P],
    # D -> bytes of shared memory the backward's larger FMA kernel needs
    "repro_flash_attention_bwd_smem": [_I],
    # D, dtype -> 1 when K1 and K1-bwd run on the tensor cores
    "repro_flash_attention_tensor_cores": [_I, _I],
    # q, k_pool, v_pool, page_table, kv_len, out, B, KH, G, D, P, page,
    # max_pages, scale, dtype, stream, splits, partials (nullable)
    "repro_paged_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P, _I, _P],
    # q, k_pool, v_pool, page_table, base_len, out, B, T, KH, G, D, P,
    # page, max_pages, scale, dtype, stream, splits, partials (nullable)
    "repro_paged_attention_mq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _P, _I, _P],
    # rows = T * G, D, page, dtype -> query rows of one of K3's row tiles
    "repro_paged_attention_mq_tile_rows": [_I, _I, _I, _I],
    # D, page, dtype -> 1 when K2 and K3 walk on the tensor cores
    "repro_paged_tensor_cores": [_I, _I, _I],
    # max_pages, page, splits -> table entries a split walks (0: refused)
    "repro_paged_split_pages": [_I, _I, _I],
    # stream: one launch of an empty kernel (the launch floor)
    "repro_launch_floor": [_P],
    # q, k, v, i_pre, f_pre, h, m (nullable), qn (nullable), the final
    # state C, n, m (nullable), B, H, S, D, DV, scale, dtype, stream,
    # tensor_cores (host int: 1 when the tensor-core kernel launched)
    "repro_mlstm_scan": [_P] * 11 + [_I] * 5 + [_F, _I, _P, _P],
    # D, DV, dtype -> 1 when K6 and K6-bwd run on the tensor cores
    "repro_mlstm_scan_tensor_cores": [_I, _I, _I],
    # D -> bytes of shared memory K6's FMA kernel needs
    "repro_mlstm_scan_smem": [_I],
    # () -> bytes of shared memory of the tensor-core walks
    "repro_mlstm_scan_tc_smem": [],
    # q, k, v, i_pre, f_pre, h, m, qn, dh, rden, dqn, qdq, kdk, dq, dk, dv,
    # d i_pre, d f_pre, B, H, S, D, DV, scale, dtype, stream, tensor_cores
    "repro_mlstm_scan_bwd": [_P] * 18 + [_I] * 5 + [_F, _I, _P, _P],
    # D, DV -> bytes of shared memory K6-bwd's larger FMA walk needs
    "repro_mlstm_scan_bwd_smem": [_I, _I],
    # x, dt, A, B, C, D, y, ckpt (nullable), the final state (nullable),
    # B, S, Din, N, dtype, stream
    "repro_ssm_scan": [_P] * 9 + [_I] * 5 + [_P],
    # () -> the steps between K5's checkpoints
    "repro_ssm_scan_chunk": [],
    # () -> the largest state size N of K5 and K5-bwd
    "repro_ssm_scan_max_state": [],
    # x, dt, A, B, C, D, ckpt, dy, dx, ddt, part_bc, part_dA, part_dD, dB,
    # dC, dA, dD, B, S, Din, N, dtype, stream
    "repro_ssm_scan_bwd": [_P] * 17 + [_I] * 5 + [_P],
    # () -> channels a block of K5-bwd covers
    "repro_ssm_scan_channels_per_block": [],
    # x, sizes, w, out, sched, M, K, N, E, trans, dtype, stream,
    # tensor_cores (host int: 1 when the tensor-core kernel launched)
    "repro_moe_gmm": [_P] * 5 + [_I] * 6 + [_P, _P],
    # K, N, dtype -> 1 when K4 runs on the tensor cores
    "repro_moe_gmm_tensor_cores": [_I, _I, _I],
    # sizes, sched, tiles, M, N, E, blocks, max_steps, stream -> the
    # tensor-core path's walk written out
    "repro_moe_gmm_walk": [_P] * 3 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the CUDA toolkit's default
    location.  Raises when there is none (a CPU-only machine)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "the CUDA kernels need nvcc to build, and none was found (not on "
            "PATH, not at /usr/local/cuda/bin/nvcc); on a CPU tensor the "
            "kernel wrappers take their plain PyTorch versions instead")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels into the build directory (no-op when a library
    of the same sources exists) and return the library's path."""
    lib_path = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: readers never see a partial file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# the steps of a launch a C entry reports on a failure (LaunchStep,
# csrc/common.cuh)
STEPS = {1: "the shared-memory allowance", 2: "a tensor map",
         3: "a kernel launch"}


def check(err: int, name: str, step: Optional[ctypes.c_int] = None) -> None:
    """Raise if a C entry point reported a CUDA error, naming the step that
    failed where the entry reports it through ``step``."""
    if err != 0:
        at = (f" at {STEPS.get(step.value, f'step {step.value}')}"
              if step is not None and step.value else "")
        raise RuntimeError(f"{name} failed to launch{at}: cudaError_t {err}")
