"""Data pipeline of the port: a copy of the reference's deterministic
synthetic token stream (numpy only).  Every batch is a pure function of
(config, seed, step, host shard), byte-identical to the reference's, so
the port trains on exactly the data the reference trains on and a
resumed run replays its stream exactly."""
from repro_torch.data.pipeline import DataConfig, SyntheticStream, make_stream

__all__ = ["DataConfig", "SyntheticStream", "make_stream"]
