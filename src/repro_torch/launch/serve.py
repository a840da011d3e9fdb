"""Batched serving driver: prefill + token-by-token decode with KV caches.

The JAX package's ``launch/serve.py`` on the port: the same arguments and
report keys, plus ``--device`` (default ``cuda``; ``cpu`` for a run
without a card).  It serves a registry architecture's reduced smoke
config with random weights drawn from ``--seed``:

  prefill(prompt batch) -> caches -> decode_step x new_tokens

Request batching is continuous-lite: a fixed batch of B slots, each slot
carrying an independent prompt; slots are refilled from the queue between
decode bursts, and the last partial batch is padded by repeating its last
request.  Decoding is greedy.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_32b \\
      --requests 12 --batch 4 --prompt-len 32 --new-tokens 16
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .._device import resolve_device
from ..configs import smoke_config
from ..models import transformer as T

__all__ = ["main", "parse_args", "serve_requests"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    # --smoke and --greedy are inert: the driver always serves the smoke
    # config greedily.  They are accepted so the JAX package's command
    # lines run unchanged.
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def serve_requests(params, cfg, prompts, batch: int, new_tokens: int,
                   cache_len: int | None = None, *, rules=None):
    """Serve every row of ``prompts`` (R, P) on ``params``' device in
    batches of ``batch`` slots, ``new_tokens`` greedy tokens each.

    Returns (completed: request id -> its tokens, stats): the seconds spent
    in prefill (through the first token read back) and in decode steps,
    the decode steps, the batches and the count of non-finite logits
    (read once, at the end).  Under a mesh (``rules``) every rank calls
    it with the same prompts and its blocks of the parameters; each step's
    logits are gathered (``transformer.gather_logits``) before the greedy
    pick, so every rank serves the same tokens.
    """
    P = prompts.shape[1]
    cache_len = cache_len or (P + new_tokens)
    queue = list(range(prompts.shape[0]))
    completed: dict[int, list[int]] = {}
    stats = {"prefill_seconds": 0.0, "decode_seconds": 0.0,
             "decode_steps": 0, "batches": 0}
    nonfinite = torch.zeros((), dtype=torch.int64, device=prompts.device)
    with torch.inference_mode():
        while queue:
            slot_ids = [queue.pop(0) for _ in range(min(batch, len(queue)))]
            ids = (slot_ids + [slot_ids[-1]] * batch)[:batch]
            t0 = time.perf_counter()
            logits, caches, length = T.prefill(params, cfg, prompts[ids],
                                               cache_len=cache_len,
                                               rules=rules)
            logits = T.gather_logits(logits, cfg, rules)
            nonfinite += (~torch.isfinite(logits)).sum()
            tok = torch.argmax(logits, dim=-1)
            outs = [[t] for t in tok.tolist()]  # the read waits for the card
            t1 = time.perf_counter()
            for _ in range(new_tokens - 1):
                logits, caches, length = T.decode_step(params, caches,
                                                       length, cfg, tok,
                                                       rules=rules)
                logits = T.gather_logits(logits, cfg, rules)
                nonfinite += (~torch.isfinite(logits)).sum()
                tok = torch.argmax(logits, dim=-1)
                for out, t in zip(outs, tok.tolist()):
                    out.append(t)
            t2 = time.perf_counter()
            for s, rid in enumerate(slot_ids):
                completed[rid] = outs[s]
            stats["prefill_seconds"] += t1 - t0
            stats["decode_seconds"] += t2 - t1
            stats["decode_steps"] += new_tokens - 1
            stats["batches"] += 1
    stats["nonfinite_logits"] = int(nonfinite)
    return completed, stats


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    params = T.init_params(cfg, seed=args.seed, device=dev)
    # prompts from a CPU generator: the same requests on any device
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.requests, args.prompt_len),
                            generator=gen).to(dev)
    t0 = time.perf_counter()
    completed, stats = serve_requests(params, cfg, prompts, args.batch,
                                      args.new_tokens, args.cache_len)
    dt = time.perf_counter() - t0
    tokens_out = sum(len(v) for v in completed.values())
    report = {
        "arch": cfg.name,
        "requests": args.requests,
        "batches": stats["batches"],
        "new_tokens_per_request": args.new_tokens,
        "tokens_generated": tokens_out,
        "tokens_per_second": tokens_out / dt,
        "seconds": dt,
        "sample_output": completed[0][:8],
        "device": str(dev),
        "prefill_seconds": stats["prefill_seconds"],
        "decode_seconds": stats["decode_seconds"],
        "decode_steps": stats["decode_steps"],
        "nonfinite_logits": stats["nonfinite_logits"],
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
