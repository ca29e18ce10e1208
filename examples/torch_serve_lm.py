"""Batched serving from the PyTorch port: prefill a batch of prompts and
decode with sampling (the paper's inference scenario: W1A8 weights, KV
cache).

    PYTHONPATH=src python examples/torch_serve_lm.py [--ckpt results/torch_train100m_example/ckpt]
    PYTHONPATH=src python examples/torch_serve_lm.py --reduced --device cpu --continuous --prefix-cache

The flags are ``examples/serve_lm.py``'s, without ``--mesh``, plus
``--device`` (default: the CUDA device).  Generation runs on the port's
``DecodeEngine`` (prefill, then the decode loop with every token on the
device: one host transfer a call).  ``--compare`` also times the
per-token Python loop (one transfer a token); ``--stream`` prints tokens
chunk by chunk; ``--continuous`` serves the prompts through the
continuous-batching engine instead (ragged prompts, per-request seeds,
paged KV pool), with ``--prefix-cache`` reusing cached prompt blocks;
``--packed`` serves the bit-packed integer export, so every decode linear
runs the W1A8 GEMV kernels.

Without ``--ckpt`` it serves a freshly initialised reduced model (tokens
are synthetic ids); with a checkpoint of ``examples/torch_train_lm.py`` it
decodes that model.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.train.serve import BatchedServer, SamplerConfig
from repro_torch.train.trainer import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pquant-100m")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compare", action="store_true",
                    help="also time the per-token Python loop")
    ap.add_argument("--stream", action="store_true", help="stream tokens chunk by chunk")
    ap.add_argument("--stream-chunk", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the continuous-batching engine (ragged prompts, "
                         "paged KV pool)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching (--continuous only): every prompt is "
                         "submitted twice so the second pass hits the cached blocks")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="token budget per step for chunked admission prefill "
                         "(--continuous only)")
    ap.add_argument("--packed", action="store_true",
                    help="serve the packed integer export: decode runs the W1A8 GEMV "
                         "kernels on stored integers (paper Appendix A)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced or not args.ckpt:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, dtype="float32")

    if args.ckpt:
        state = init_train_state(0, cfg, device=device)
        tree = Checkpointer(args.ckpt).restore({"params": state.params, "opt": state.opt})
        params = tree["params"]
        print(f"restored checkpoint step {int(tree['opt'].step)}")
    else:
        params = api.init_model(0, cfg, device=device)
        print("serving a randomly initialised reduced model")

    if args.packed:
        from repro_torch.train.quantized_serving import quantize_params_for_serving

        params = quantize_params_for_serving(params, cfg, packed=True)
        print("serving the packed integer export (W1A8 kernels)")

    scfg = SamplerConfig(temperature=0.8, top_k=40, max_new_tokens=args.new_tokens)
    rng = np.random.default_rng(0)

    if args.continuous:
        from repro_torch.serve.scheduler import ContinuousBatchingEngine

        max_len = args.prompt_len + args.new_tokens
        max_len += (-max_len) % args.block_size
        num_slots = max(2, args.batch // 2)
        # a pool with room to keep finished prompts cached: at full slot
        # occupancy and no slack every parked block is evicted at once
        nb = num_slots * -(-max_len // args.block_size)
        eng = ContinuousBatchingEngine(
            params, cfg, num_slots=num_slots, max_len=max_len, scfg=scfg, layout="paged",
            block_size=args.block_size, prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache, num_blocks=2 * nb if args.prefix_cache else None,
            device=device,
        )
        if args.prefill_chunk and eng.prefill_chunk is None:
            print("note: config is not chunk-safe; one-shot admission")
        if args.prefix_cache and not eng.prefix_cache:
            print("note: config declines prefix caching; running cold")
        t0 = time.time()
        # with --prefix-cache every prompt goes in twice: the repeats (same
        # prompt and seed, another uid) hit the first pass's blocks and must
        # give the same stream
        prompts = [rng.integers(3, cfg.vocab_size, max(1, args.prompt_len - i % 4))
                   for i in range(args.batch)]
        for r in range(2 if args.prefix_cache else 1):
            for i, prompt in enumerate(prompts):
                eng.submit(prompt, max_new_tokens=args.new_tokens, seed=i,
                           uid=r * args.batch + i)
        finished = eng.run()
        dt = time.time() - t0
        total = sum(len(f.tokens) for f in finished)
        print(f"continuous batching: {len(finished)} requests, {total} tokens in {dt:.1f}s "
              f"({total / dt:.1f} tok/s); pool free {eng.allocator.free_count}/"
              f"{eng.num_blocks}, {eng.preemptions} preemptions")
        if eng.prefix_cache:
            c = eng.snapshot()["counters"]
            streams = {}
            match = all(streams.setdefault(f.uid % args.batch, f.tokens.tolist())
                        == f.tokens.tolist() for f in finished)
            print(f"prefix cache: {c['prefix_cache_hits_total']} hits / "
                  f"{c['prefix_cache_misses_total']} misses, "
                  f"{c['prefix_cache_hit_tokens_total']} tokens reused, "
                  f"{c['prefix_cache_cow_total']} CoW; repeat streams identical: {match}")
        for f in sorted(finished, key=lambda f: f.uid)[:4]:
            print(f"  request {f.uid} ({f.finish_reason}): {f.tokens.tolist()}")
        return 0

    server = BatchedServer(params, cfg, max_len=args.prompt_len + args.new_tokens + 1,
                           device=device)
    prompts = rng.integers(3, cfg.vocab_size, (args.batch, args.prompt_len))
    toks = args.batch * args.new_tokens

    t0 = time.time()
    if args.stream:
        chunks = []
        for i, chunk in enumerate(server.generate_stream(prompts, scfg,
                                                         chunk=args.stream_chunk)):
            chunks.append(chunk)
            print(f"  chunk {i}: +{chunk.shape[1]} tokens ({time.time() - t0:.1f}s in)")
        out = np.concatenate(chunks, axis=1)
    else:
        out = server.generate(prompts, scfg)
    dt = time.time() - t0
    print(f"generated {out.shape} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s batched, "
          "incl. prefill)")
    for i, row in enumerate(out[: min(4, args.batch)]):
        print(f"  request {i}: {row.tolist()}")

    if args.compare:
        # warm both paths, then time steady-state generation
        server.generate(prompts, scfg)
        loop = server.generate_python_loop(prompts, scfg)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.time()
        server.generate_python_loop(prompts, scfg)
        t_py = time.time() - t0
        t0 = time.time()
        out = server.generate(prompts, scfg)
        t_en = time.time() - t0
        print(f"python loop: {toks / t_py:.1f} tok/s | engine: {toks / t_en:.1f} tok/s | "
              f"speedup {t_py / t_en:.2f}x; same tokens: {bool((loop == out).all())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
