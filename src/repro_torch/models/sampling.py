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
pos)``.  Speculative decoding adds a tag per purpose: a stream keyed by
``(seed, slot, position, tag)``, as the reference's ``spec_keys`` are.
PyTorch cannot reproduce ``fold_in``'s bits, so temperature draws
differ from the reference's; only their distribution agrees.
"""
from __future__ import annotations

import hashlib

import torch


def slot_seed(seed: int, slot: int, pos: int, tag=None) -> int:
    """A 63-bit generator seed for one (engine seed, slot, position).  A
    ``tag`` keys a separate stream for one purpose at the same position
    (the speculative draws of :mod:`repro_torch.models.speculate`); with
    no tag the key is the plain sampler's."""
    key = f"{seed}/{slot}/{pos}" if tag is None else f"{seed}/{slot}/{pos}/{tag}"
    h = hashlib.blake2b(key.encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def _generator(device, seed: int, slot: int, pos: int, tag) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(slot_seed(seed, slot, pos, tag))
    return gen


def gumbel_draw(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw from ``softmax(logits)`` for a ``(V,)`` row by the
    Gumbel-max trick, with noise from ``gen`` (on the row's device);
    returns a 0-d int64 tensor there."""
    u = torch.rand(logits.shape[-1], generator=gen,
                   device=logits.device).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel)


def gumbel_argmax(logits: torch.Tensor, *, seed: int, slot: int, pos: int,
                  tag=None) -> torch.Tensor:
    """:func:`gumbel_draw` with the noise of stream ``(seed, slot, pos,
    tag)``."""
    return gumbel_draw(logits, _generator(logits.device, seed, slot, pos,
                                          tag))


def uniform(*, seed: int, slot: int, pos: int, tag, device) -> torch.Tensor:
    """One uniform draw in ``[0, 1)`` from stream ``(seed, slot, pos,
    tag)``: a 0-d float32 tensor on ``device``."""
    gen = _generator(device, seed, slot, pos, tag)
    return torch.rand((), generator=gen, device=device)


def sample_tokens(logits: torch.Tensor, temperatures, *, seed: int, slots,
                  pos, greedy_only: bool = False, tag=None) -> torch.Tensor:
    """Sample one token per row of ``logits`` (B, V) -> (B,) int32.

    ``temperatures``, ``slots`` and ``pos`` hold B values each (tensors or
    sequences); ``slots``/``pos`` (and ``tag``) key each row's random
    stream and are read on the host only when some row samples.
    ``greedy_only`` skips the draw when the caller knows every row is
    greedy; the result is the same either way."""
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
        out[b] = gumbel_argmax(logits32[b] / float(temps[b]), seed=seed,
                               slot=slots[b], pos=pos[b], tag=tag)
    return out
