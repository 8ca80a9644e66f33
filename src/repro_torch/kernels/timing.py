"""Device time of a call on the card: the yardstick of every kernel time
that ``chip_smoke.py`` and the ``python -m repro_torch.launch.profile_*``
tools print."""
from __future__ import annotations

import statistics

import torch

L2_BYTES = 50 * 2 ** 20  # the H100's L2 cache


def time_ms(fn, reps: int = 15, inner: int = 20, cold: int = 0) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in a
    CUDA graph, so the host's launch overhead is not counted; the graph is
    replayed ``reps`` times between CUDA events, and the median per call is
    returned.

    By default (``cold = 0``) ``fn()`` is called each time and its inputs
    stay in the 50 MB L2 between calls: the time of a kernel that finds
    its inputs hot.  The serving loop does not: between two calls of an
    attention kernel a decode step streams a layer's weights (about 80 MB
    of MLP alone at qwen2-1.5b), so the page pools arrive cold.  With
    ``cold = n``, ``fn`` takes an index and call ``j`` of the graph is
    ``fn(j % n)``: the caller holds ``n`` copies of its large inputs,
    together more than the L2 (see :func:`cold_copies`), so that each call
    finds its copy evicted by the others.  ``inner`` is raised to ``n``
    when smaller, so that every copy is used."""
    if cold:
        inner = max(inner, cold)
        calls = [(lambda j=j: fn(j % cold)) for j in range(inner)]
    else:
        calls = [fn] * inner
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:3]:  # warm up outside the capture
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def cold_copies(nbytes: int) -> int:
    """Copies of inputs of ``nbytes`` that together hold more than twice
    the L2, so that a rotation through them (``time_ms(cold=...)``) finds
    each one cold."""
    return max(2, -(-2 * L2_BYTES // max(1, nbytes)))


def launch_floor_ms(reps: int = 15, inner: int = 20) -> float:
    """Device time of one launch of an empty kernel in a CUDA graph, timed
    as :func:`time_ms` times a kernel: the floor under any launch's time."""
    from repro_torch.kernels import build

    lib = build.library()

    def empty():
        build.check(lib.repro_launch_floor(
            torch.cuda.current_stream().cuda_stream), "repro_launch_floor")

    return time_ms(empty, reps, inner)
