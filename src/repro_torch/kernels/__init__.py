"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each ported TPU kernel ships as:
  * ``csrc/<name>.cu``  — the CUDA C++ kernel for ``sm_90a`` with a plain C
    entry point;
  * ``<name>.py``       — the wrapper: checks, launch counter, and the
    choice by device (plain version on a CPU tensor, kernel on a CUDA
    tensor);
  * ``ref.py``          — the plain versions (the semantics the kernels
    are held against);
  * ``ops.py``          — the public functions in the reference layout;
  * ``build.py``        — the ``nvcc`` build and the ``ctypes`` binding.

Nothing here builds or imports a compiler when it is imported: the
library is built at the first launch on a CUDA tensor.
"""
