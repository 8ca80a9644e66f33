"""Serving entry point of the port: continuous-batching engine demo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16 --max-new 24

    # chunked decode: 8 tokens per host transfer
    PYTHONPATH=src python -m repro_torch.launch.serve --chunk 8

    # paged KV cache: pool pages + prefix sharing
    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged

    # on the CPU (the plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Like the reference entry point it serves the reduced config of ``--arch``
with random weights from ``--seed``.  ``--engine legacy``, ``--spec-k``
and ``--draft`` are accepted for the reference's command lines and raise
``NotImplementedError`` until those paths are ported.
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
                    help="fused on-device sampling or the paged KV cache "
                         "(legacy is not ported yet)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="tokens decoded per host transfer")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (engine=paged; power of two)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative drafts per verify round (0 = off; "
                         "not ported yet)")
    ap.add_argument("--ngram-n", type=int, default=3,
                    help="n-gram order for the prompt-lookup proposer")
    ap.add_argument("--draft", default="",
                    help="draft model arch name (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a GPU")
    args = ap.parse_args()

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    draft = build_model(reduced(get_config(args.draft)), args.device) \
        if args.draft else None
    engine = ServeEngine(model, params, max_batch=args.max_batch,
                         max_seq=args.prompt_len + args.max_new + 8,
                         engine=args.engine, decode_chunk=args.chunk,
                         page_size=args.page_size, spec_k=args.spec_k,
                         draft=draft, seed=args.seed)
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
    for c in done[:3]:
        print(f"  uid={c.uid} reason={c.finished_reason} tokens={c.tokens[:8]}...")


if __name__ == "__main__":
    main()
