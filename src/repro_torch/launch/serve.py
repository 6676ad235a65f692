"""Batched serving launcher: continuous-batch decode against a KV cache.

``python -m repro_torch.launch.serve [--arch gemma-2b] [--smoke]
[--device cpu]``

Maintains a fixed decode batch; finished requests (length) are replaced
from the queue — a miniature continuous-batching loop over
:mod:`repro_torch.launch.steps`' ``serve_step``, as the reference's
``repro.launch.serve``.  Runs on the CUDA card unless given
``--device cpu``.  The port serves every family of the zoo: dense
(gemma-2b, the default, stablelm-3b, deepseek-coder-33b, granite-34b),
moe (olmoe-1b-7b, kimi-k2-1t-a32b), ssm (xlstm-125m), vlm (qwen2-vl-7b,
whose M-RoPE takes ``(B, 3, 1)`` positions, all three ids the shared
position), hybrid (zamba2-2.7b) and audio (seamless-m4t-medium).  For the
audio family each step's batch carries ``min(encoder_seq, 32)`` zero
frames and an all-true mask, as the reference's loop does, and like it
the loop never prefills the encoder memory: cross-attention reads the
cache's empty, fully masked memory (ROADMAP C.14).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import model
from repro_torch.models.sampling import sample_logits


def serve(cfg, params, *, requests: int = 8, batch: int = 4,
          max_new: int = 16, max_len: int = 64, temperature: float = 0.0,
          top_k: int = 0, device=None) -> Dict[str, Any]:
    """Serve ``requests`` prompts (lengths 4..11, drawn from numpy seed 0)
    through ``batch`` decode slots; returns counts and host seconds.

    Every slot advances one shared position per step (prompts are
    teacher-forced, then generation), the reference's simplification:
    a slot's new request sees the cache its predecessor left."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
             for _ in range(requests)]
    B = batch
    cache = model.init_cache(cfg, B, max_len, dev)
    step = make_serve_step(cfg)
    active = [None] * B  # [request_id, remaining_prompt, generated]
    next_req = done = steps = tokens_out = pos = 0
    cur = np.zeros((B, 1), np.int64)
    outputs = {}
    se = min(cfg.encdec.encoder_seq, 32) if cfg.family == "audio" else 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    while done < requests and pos < max_len - 1:
        for s in range(B):
            if active[s] is None and next_req < len(queue):
                active[s] = [next_req, list(queue[next_req]), 0]
                outputs[next_req] = []
                next_req += 1
        batch = {"tokens": torch.as_tensor(cur, device=dev)}
        if cfg.rope_type == "mrope":
            batch["positions"] = torch.full((B, 3, 1), pos,
                                            dtype=torch.int32, device=dev)
        if cfg.family == "audio":
            batch["enc_embeddings"] = torch.zeros((B, se, cfg.d_model),
                                                  device=dev)
            batch["enc_mask"] = torch.ones((B, se), dtype=torch.bool,
                                           device=dev)
        logits, cache = step(params, batch, cache, pos)
        gen = (torch.Generator(dev).manual_seed(pos)
               if temperature > 0 else None)
        nxt = sample_logits(gen, logits[:, -1], temperature=temperature,
                            top_k=top_k).cpu().numpy()
        for s in range(B):
            if active[s] is None:
                continue
            rid, prompt, _ = active[s]
            if prompt:
                cur[s, 0] = prompt.pop(0)  # teacher-force the prompt
            else:
                cur[s, 0] = nxt[s]
                outputs[rid].append(int(nxt[s]))
                active[s][2] += 1
                tokens_out += 1
                if active[s][2] >= max_new:
                    done += 1
                    active[s] = None
        pos += 1
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"done": done, "requests": requests, "tokens": tokens_out,
            "steps": steps, "seconds": time.perf_counter() - t0,
            "outputs": outputs}


def main(argv=None) -> Dict[str, Any]:
    """Serve from the command line; returns :func:`serve`'s result with
    the arch served (``"arch"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "audio":
        print("enc-dec serving: decoder-side continuous batching with a "
              "fixed encoder memory per request (stub embeddings)")
    dev = resolve_device(args.device)
    params = model.init(0, cfg, dev)
    r = serve(cfg, params, requests=args.requests, batch=args.batch,
              max_new=args.max_new, max_len=args.max_len,
              temperature=args.temperature, top_k=args.top_k, device=dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"served {r['done']}/{r['requests']} requests, {r['tokens']} "
          f"tokens in {r['steps']} steps, {r['seconds']:.1f}s "
          f"({r['tokens'] / max(r['seconds'], 1e-9):.1f} tok/s on {where})")
    return dict(r, arch=cfg.arch_id)


if __name__ == "__main__":
    main()
