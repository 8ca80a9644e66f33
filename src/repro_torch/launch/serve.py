"""Serving entry point of the port: continuous-batching engine demo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16 --max-new 24

    # chunked decode: 8 tokens per host transfer
    PYTHONPATH=src python -m repro_torch.launch.serve --chunk 8

    # the per-slot legacy baseline: (B, V) logits to the host each step
    PYTHONPATH=src python -m repro_torch.launch.serve --engine legacy

    # paged KV cache: pool pages + prefix sharing
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged

    # lossless speculative decoding: n-gram drafts, one verify pass
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged --spec-k 4

    # ... or draft with a smaller same-vocab model
    PYTHONPATH=src python -m repro_torch.launch.serve --spec-k 4 \
        --draft qwen1.5-4b

    # on the CPU (the plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

    # any architecture of the reference: the MoE decoders (every engine),
    # hymba and the xLSTM (the fused engine), whisper, phi-3-vision
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3.5-moe-42b-a6.6b --engine paged --spec-k 4

Like the reference entry point it serves the reduced config of ``--arch``
with random weights from ``--seed`` (the draft's from ``--seed + 1``).
Requests of one prompt length make one admission group, which the
models without padded prefill (the MoE decoders, hymba, the xLSTM)
need.  ``--engine legacy`` serves through the reference's per-slot
baseline (host sampling, one request a slot admitted at a time).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="fused",
                    choices=["fused", "legacy", "paged"],
                    help="fused on-device sampling, the per-slot legacy "
                         "baseline (host sampling) or the paged KV cache")
    ap.add_argument("--chunk", type=int, default=1,
                    help="tokens decoded per host transfer")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (engine=paged; power of two)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative drafts per verify round (0 = off)")
    ap.add_argument("--ngram-n", type=int, default=3,
                    help="n-gram order for the prompt-lookup proposer")
    ap.add_argument("--draft", default="",
                    help="draft model arch name (same vocab); empty = "
                         "n-gram proposer")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a GPU")
    args = ap.parse_args()

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    draft = dparams = None
    if args.draft:
        draft = build_model(reduced(get_config(args.draft)), args.device)
        dparams = draft.init(args.seed + 1)
    engine = ServeEngine(model, params, max_batch=args.max_batch,
                         max_seq=args.prompt_len + args.max_new + 8,
                         engine=args.engine, decode_chunk=args.chunk,
                         page_size=args.page_size, spec_k=args.spec_k,
                         spec_ngram_n=args.ngram_n, draft=draft,
                         draft_params=dparams, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        engine.submit(Request(
            uid=i,
            prompt=rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        ))
    t0 = time.time()
    done = engine.run()
    dt = time.time() - t0
    toks = sum(len(c.tokens) for c in done)
    print(f"arch={args.arch} engine={args.engine} chunk={args.chunk} "
          f"device={model.device} requests={len(done)} tokens={toks} "
          f"wall={dt:.2f}s throughput={toks/dt:,.1f} tok/s "
          f"d2h_transfers={engine.d2h_transfers}")
    if args.engine == "paged":
        print(f"  pages={engine.pool.capacity} page_size={args.page_size} "
              f"prefix_hit_rate={engine.pool.hit_rate:.3f} "
              f"({engine.pool.prefix_hits}/{engine.pool.prefix_lookups})")
    if args.spec_k > 0:
        stats = engine.kv_stats()
        print(f"  spec_k={args.spec_k} "
              f"proposer={'draft:' + args.draft if args.draft else 'ngram'} "
              f"accept_rate={stats['spec_accept_rate']:.3f} "
              f"tokens_per_round={stats['spec_tokens_per_round']:.2f}")
    for c in done[:3]:
        print(f"  uid={c.uid} reason={c.finished_reason} tokens={c.tokens[:8]}...")


if __name__ == "__main__":
    main()
