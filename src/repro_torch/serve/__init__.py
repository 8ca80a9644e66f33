"""Serving in PyTorch: the continuous-batching engine (fused and paged)
over the port's model API.  ``smoke_serve`` is the one-call harness.
``serve.sharded`` serves the dense decoders on a mesh, split over
``model``."""
from repro_torch.serve.engine import (Completion, PagePool, Request,
                                      ServeEngine, smoke_serve)

__all__ = ["Completion", "PagePool", "Request", "ServeEngine", "smoke_serve"]
