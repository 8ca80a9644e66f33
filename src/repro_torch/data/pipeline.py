"""Deterministic, shardable synthetic data pipeline.

A copy of the reference package's ``data/pipeline.py`` (numpy only, so
the copy is verbatim but for the config import): ``batch_at`` gives
byte-identical batches to the reference's for the same seed, step and
shard.

Every batch is a pure function of (seed, step, host_shard) — the property
that makes checkpoint/restart and elastic rescaling exact: a restarted or
re-sharded job regenerates precisely the batches it would have seen.
Workflow templates pin (dataset_name, seed) so runs are reproducible and
comparable across backends, mirroring Adviser's provenance guarantees.

The generator produces power-law token streams with enough structure
(bigram correlations) that a model's loss visibly decreases — adequate for
end-to-end examples, integration tests and throughput benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "synthetic-lm"
    seed: int = 0
    vocab_size: int = 256
    # structure knobs
    zipf_a: float = 1.3
    bigram_weight: float = 0.5


class SyntheticStream:
    """Sharded synthetic token stream.

    host_id/num_hosts split the global batch — each host generates only its
    shard (what a multi-host input pipeline does with files).
    """

    def __init__(self, dcfg: DataConfig, model_cfg: ModelConfig,
                 batch: int, seq_len: int,
                 host_id: int = 0, num_hosts: int = 1):
        assert batch % num_hosts == 0, (batch, num_hosts)
        self.dcfg = dcfg
        self.model_cfg = model_cfg
        self.global_batch = batch
        self.local_batch = batch // num_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        v = min(dcfg.vocab_size, model_cfg.vocab_size)
        rng = np.random.default_rng(dcfg.seed)
        # fixed bigram transition structure shared by all hosts
        self._next_tok = rng.integers(1, v, size=v)
        self._v = v

    def _chain_to(self, k: int) -> np.ndarray:
        """The (k+1, v) transition-chain table: row j maps a token to the
        one reached after following the bigram table j times (row 0 is
        the identity).  Grown lazily to the longest follow-run observed
        and cached on the instance — built on first use so streams
        restored from older pickles (the cross-run stage cache) work."""
        chain = getattr(self, "_chain", None)
        if chain is None:
            chain = np.arange(self._v, dtype=self._next_tok.dtype)[None]
        if chain.shape[0] <= k:
            rows = list(chain)
            while len(rows) <= k:
                rows.append(self._next_tok[rows[-1]])
            chain = np.stack(rows)  # one allocation, O(k·v) total
        self._chain = chain
        return chain

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a given global step (pure function)."""
        rng = np.random.default_rng(
            (self.dcfg.seed, step, self.host_id, 0xA11CE)
        )
        B, S, v = self.local_batch, self.seq_len, self._v
        base = rng.zipf(self.dcfg.zipf_a, size=(B, S)) % (v - 1) + 1
        # inject bigram structure: with prob w, token follows the table.
        # The sequential recurrence toks[t] = follow[t] ?
        # next_tok[toks[t-1]] : base[t] is closed-form: inside a run of
        # consecutive follows the value is the k-step transition chain
        # applied to the run's anchor (the last non-followed base token),
        # so the whole batch resolves in one gather — byte-identical to
        # the old per-position loop (asserted in tests) at O(S·v) chain
        # build cost amortized across batches.
        follow = rng.random((B, S)) < self.dcfg.bigram_weight
        follow[:, 0] = False  # position 0 has no predecessor
        idx = np.arange(S)
        anchor = np.maximum.accumulate(np.where(follow, 0, idx[None]), axis=1)
        run_len = idx[None] - anchor
        chain = self._chain_to(int(run_len.max()) if S else 0)
        anchor_tok = np.take_along_axis(base, anchor, axis=1)
        toks = chain[run_len, anchor_tok].astype(np.int32)
        out = {"tokens": toks}
        cfg = self.model_cfg
        if cfg.is_encoder_decoder:
            out["frames"] = rng.standard_normal(
                (B, cfg.encoder_frames, cfg.d_model)
            ).astype(np.float32) * 0.02
        if cfg.family == "vlm" and cfg.num_image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_stream(model_cfg: ModelConfig, shape: ShapeConfig,
                dcfg: Optional[DataConfig] = None,
                host_id: int = 0, num_hosts: int = 1) -> SyntheticStream:
    dcfg = dcfg or DataConfig(vocab_size=min(4096, model_cfg.vocab_size))
    return SyntheticStream(
        dcfg, model_cfg, shape.global_batch, shape.seq_len, host_id, num_hosts
    )
