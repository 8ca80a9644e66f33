"""Batched token sampling for the serving hot path.

Counterpart of the reference package's ``models/sampling.py``.  Rows
with ``temperature <= 0`` take the greedy argmax in float32 (lowest
index on ties, as ``jnp.argmax`` gives), so greedy tokens agree with the
reference wherever the logits do.

Rows with ``temperature > 0`` draw ``categorical(logits / T)`` by the
Gumbel-max trick, with noise from a ``torch.Generator`` on the logits'
device (Philox on CUDA; the CPU generator on the CPU) seeded by the
triple ``(seed, slot, position)``.  A slot's stream is therefore a pure
function of the engine seed, the slot and the token position —
independent of its neighbours and reproducible run to run — which is
the property the reference gets from ``fold_in(fold_in(key, slot),
pos)``.  PyTorch cannot reproduce ``fold_in``'s bits, so temperature
draws differ from the reference's; only their distribution agrees.
"""
from __future__ import annotations

import hashlib

import torch


def slot_seed(seed: int, slot: int, pos: int) -> int:
    """A 63-bit generator seed for one (engine seed, slot, position)."""
    h = hashlib.blake2b(f"{seed}/{slot}/{pos}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def sample_tokens(logits: torch.Tensor, temperatures, *, seed: int, slots,
                  pos, greedy_only: bool = False) -> torch.Tensor:
    """Sample one token per row of ``logits`` (B, V) -> (B,) int32.

    ``temperatures``, ``slots`` and ``pos`` hold B values each (tensors or
    sequences); ``slots``/``pos`` key each row's random stream and are
    read on the host only when some row samples.  ``greedy_only`` skips
    the draw when the caller knows every row is greedy; the result is the
    same either way."""
    logits32 = logits.float()
    greedy = torch.argmax(logits32, dim=-1).to(torch.int32)
    if greedy_only:
        return greedy
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu()
    hot = torch.nonzero(temps > 0).flatten().tolist()
    if not hot:
        return greedy
    slots = torch.as_tensor(slots).tolist()
    pos = torch.as_tensor(pos).tolist()
    out = greedy.clone()
    for b in hot:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(slot_seed(seed, slots[b], pos[b]))
        u = torch.rand(logits32.shape[-1], generator=gen,
                       device=logits.device).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        out[b] = torch.argmax(logits32[b] / float(temps[b]) + gumbel)
    return out
