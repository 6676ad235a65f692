"""Token sampling utilities for the serving path.

Random draws come from a :class:`torch.Generator`; they differ from the
reference's ``jax.random.categorical`` draws by construction (two
generators), so only the greedy choice and the filtered token sets are
comparable across the two packages.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def filter_logits(logits: Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> Tensor:
    """The f32 logits ``sample_logits`` draws from: scaled by
    ``temperature``, then -inf outside the top-k and outside the top-p
    nucleus (filters compose: top_k first, then top_p)."""
    logits = logits.float() / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative mass passes top_p (inclusive)
        keep_sorted = cum - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             -torch.inf).amax(-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_logits(gen: Optional[torch.Generator], logits: Tensor, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> Tensor:
    """Sample token ids from (B, V) logits.

    temperature=0 -> greedy; top_k keeps the k best; top_p keeps the
    smallest nucleus whose probability mass >= top_p.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature=temperature,
                                        top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def perplexity(logits: Tensor, labels: Tensor,
               mask: Optional[Tensor] = None) -> Tensor:
    """exp(mean token NLL) over (B, S, V) logits / (B, S) labels."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        mean = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    else:
        mean = nll.mean()
    return torch.exp(mean)
