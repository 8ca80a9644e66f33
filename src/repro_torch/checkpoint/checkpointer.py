"""Checkpointing of the port: async save, atomic commit, rotation, exact
restore.

Counterpart of the reference package's ``checkpoint/checkpointer.py``,
with the same on-disk layout, so either package restores what the other
wrote:

  * ``<dir>/step_XXXXXXXX/arrays.npz`` holds one array per leaf, keyed
    by its ``/`` path (``params/blocks/attn_wq``, ``opt/count``);
    bfloat16 leaves are stored as uint16 views;
  * ``manifest.json`` records the step and each leaf's key, shape and
    true dtype;
  * **async**: the device->host copy is made on the caller's thread, the
    write on a background thread, so the loop waits only for the copy;
  * **atomic**: the write goes to ``step_XXXXXXXX.tmp`` and is renamed
    after an fsync — a save killed midway never shadows the newest
    committed step;
  * **rotation**: the last ``keep`` steps are kept;
  * **on a mesh** (``shardings``, the layouts of the state's leaves):
    ``save`` gathers each leaf whole and rank 0 alone writes it, every
    rank waiting for the commit; ``restore`` reads each leaf and keeps
    this rank's block.  The files hold whole leaves whatever world wrote
    them, so a checkpoint restores on any world, and on one device with
    no mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import Tree, flatten, leaves, unflatten

# numpy has no bfloat16: store it as a uint16 view and record the true
# dtype (the reference's encoding)
def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as ``(numpy array to store, true dtype name)``."""
    x = x.detach().to("cpu")
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype_name == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # a save whose commit the world awaits

    # ------------------------------------------------------------------
    def save(self, step: int, state: Tree, *, blocking: bool = False,
             shardings: Optional[Tree] = None) -> None:
        """Copy to the host on the caller's thread; write on a background
        thread (or here, with ``blocking``).  With ``shardings`` (a
        collective: every rank calls it) each leaf is gathered whole
        first; in a world of several ranks rank 0 writes."""
        self.wait()  # one save in flight at a time
        writer = not dist.is_initialized() or dist.get_rank() == 0
        lays = leaves(shardings) if shardings is not None else None
        host = []
        for i, (k, v) in enumerate(flatten(state)):
            if lays is not None:
                v = lays[i].full(v)
            if writer:
                host.append((k, *_to_host(v)))
        self._pending = _world() > 1
        if not writer:
            if blocking:
                self.wait()
            return
        manifest = {
            "step": int(step),
            "leaves": [{"key": k, "shape": list(v.shape), "dtype": dt}
                       for k, v, dt in host],
        }

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
                final = os.path.join(self.dir, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{k: v for k, v, _ in host})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._rotate()
            except BaseException as e:  # raised by the next wait()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the save in flight (in a world of several ranks, every
        rank waits for rank 0's commit); raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _steps(self) -> List[int]:
        names = os.listdir(self.dir)
        return sorted(int(n.split("_")[1]) for n in names
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def _rotate(self) -> None:
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    def latest_step(self) -> Optional[int]:
        self.wait()  # join the save in flight: commit before read
        steps = self._steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def restore(self, like: Tree, step: Optional[int] = None,
                shardings: Optional[Tree] = None) -> Tuple[Tree, int]:
        """Restore into the structure of ``like`` (default: the newest
        committed step).  Each leaf keeps the checkpoint's dtype and goes
        to the device of ``like``'s leaf at its path; a shape that differs
        from ``like``'s raises.  With ``shardings`` (the reference's
        resharding restore) each rank keeps its block of each leaf, on
        the device of the leaf's mesh, and the shape is checked against
        the layout's global shape."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
        lays = leaves(shardings) if shardings is not None else None
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            for i, (key, leaf) in enumerate(flatten(like)):
                arr = arrays[key]
                lay = lays[i] if lays is not None else None
                want = tuple(lay.shape) if lay is not None \
                    else tuple(leaf.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {want}")
                t = _from_host(arr, dtypes.get(key, arr.dtype.name))
                if lay is None:
                    out.append((key, t.to(leaf.device)))
                    continue
                device = leaf.device if lay.mesh is None else lay.mesh.device
                block = lay.local(t)
                out.append((key, block.to(device, copy=block is not t)))
        return unflatten(out), step
