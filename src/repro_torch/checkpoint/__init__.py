"""Checkpointing of the port: async (host copy on the caller's thread,
write on a background thread), atomic (temp dir + fsync + rename),
rotating, and in the reference's layout (``arrays.npz`` + a manifest of
keys, shapes and true dtypes), so a checkpoint either package wrote
restores in the other."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
