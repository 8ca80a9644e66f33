"""Models of the port behind one API: ``build_model(cfg, device)`` returns
a :class:`Model` with ``init``, ``prefill``, ``decode_step`` /
``decode_and_sample`` and the cache constructors.  Only the dense
decoder is ported so far; ``sampling`` holds the per-slot sampling the
serve engine uses."""
from repro_torch.models.api import Model, build_model, resolve_device
from repro_torch.models.sampling import sample_tokens

__all__ = ["Model", "build_model", "resolve_device", "sample_tokens"]
