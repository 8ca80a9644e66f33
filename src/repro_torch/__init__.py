"""PyTorch port of the platform's compute, for one NVIDIA H100.

The reference package ``repro`` (JAX, with Pallas kernels for the TPU)
stays as it is; this package sits beside it, imports nothing of it, and
keeps its own copy of what it needs.  Its layout follows the reference's
so each module's counterpart is easy to find: ``configs/``,
``kernels/`` (hand-written CUDA kernels for Hopper and their plain
PyTorch versions), ``models/``, ``serve/``, ``launch/``, and
``bridge.py`` (reference weights -> port weights, through numpy).

Entry points run on the card unless the caller asks for the CPU.
"""
