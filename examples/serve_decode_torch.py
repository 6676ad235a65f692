"""Serving example on PyTorch: batched autoregressive decode with a KV
cache.

The port's counterpart of ``examples/serve_decode.py``.  Instantiates the
reduced gemma-2b variant (full GQA/MQA + GeGLU machinery), prefills a
batch of prompts, then decodes tokens with `serve_step` — the same
function the decode_32k / long_500k dry-run shapes run.  Also
demonstrates the sliding-window (ring-buffer) cache used by the
long_500k variant and the decode-attention kernel.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.  Random draws
come from ``torch.Generator``s seeded as the reference seeds its
``jax.random`` keys, so the weights and prompts differ from its own.
"""

# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import argparse

import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import model


@torch.no_grad()
def greedy_decode(cfg, params, prompts, steps: int):
    B, S0 = prompts.shape
    cache = model.init_cache(cfg, B, S0 + steps, prompts.device)
    # prefill token-by-token (simple; production uses the prefill graph)
    tok = prompts[:, :1]
    logits = None
    for t in range(S0 + steps):
        logits, cache = model.serve_step(params, cfg, {"tokens": tok}, cache,
                                         t)
        nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        tok = prompts[:, t + 1:t + 2] if t + 1 < S0 else nxt
    return tok, cache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get_smoke("gemma-2b")
    params = model.init(0, cfg, dev)
    B, S0, steps = 4, 8, 8
    prompts = torch.randint(0, cfg.vocab, (B, S0), dtype=torch.int32,
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)

    print(f"serving {cfg.arch_id} (reduced): batch={B} prompt_len={S0} "
          f"decode_steps={steps}")
    last_tok, cache = greedy_decode(cfg, params, prompts, steps)
    print("full-cache decode ok; last tokens:", last_tok[:, 0].cpu().numpy())

    # sliding-window (ring buffer) variant — the long_500k configuration
    swa = cfg.replace(sliding_window=16)
    params_swa = model.init(0, swa, dev)
    last2, cache2 = greedy_decode(swa, params_swa, prompts, steps)
    print(f"sliding-window decode ok (ring cache len "
          f"{cache2['k'].shape[2]}); last tokens:",
          last2[:, 0].cpu().numpy())

    # the decode-attention kernel on the final cache state
    kv = cache["k"][0], cache["v"][0]  # layer 0: (B, S, KV, D)
    q = torch.randn((B, 1, cfg.num_kv_heads, cfg.q_per_kv, kv[0].shape[-1]),
                    generator=torch.Generator(dev).manual_seed(2),
                    device=dev).to(kv[0].dtype)
    lens = torch.full((B,), S0 + steps, dtype=torch.int32, device=dev)
    with torch.no_grad():
        out = kops.decode_attention(q, kv[0], kv[1], lens)
    print("decode-attention kernel over the cache:", tuple(out.shape))


if __name__ == "__main__":
    main()
