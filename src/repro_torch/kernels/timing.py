"""Device time of a call on the card: the yardstick of every kernel time
that ``chip_smoke.py`` and ``python -m repro_torch.launch.profile_gmm``
print."""
from __future__ import annotations

import statistics

import torch


def time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls are captured in a
    CUDA graph, so the host's launch overhead is not counted; the graph is
    replayed ``reps`` times between CUDA events, and the median per call is
    returned.  Inputs stay in the 50 MB L2 between calls, as they do when
    the serving loop calls the kernel once per layer."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
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
