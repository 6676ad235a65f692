"""Client-side estimators for L, sigma^2, G^2 (Heroes Alg. 2 lines 7-9).

All operate on parameter/gradient trees (nested dicts of tensors), along
the composed local model trajectory exactly as in the paper:

  L_n      = ||grad F_n(x_bar) - grad F_n(x_hat)|| / ||x_bar - x_hat||
  sigma^2  = E_xi ||grad F_n(x_hat; xi) - grad F_n(x_hat)||^2
  G^2      = E_xi ||grad F_n(x_hat; xi)||^2

where x_hat is the model before local training and x_bar after.  The PS
aggregates client estimates by simple averaging (Alg. 1 line 25).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

Tree = Any


def tree_leaves(t: Tree) -> list:
    """Tensor leaves of a nested dict in key-insertion order."""
    if isinstance(t, dict):
        return [leaf for v in t.values() for leaf in tree_leaves(v)]
    return [t]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_sq_norm(t: Tree) -> torch.Tensor:
    return sum(torch.sum(x * x) for x in tree_leaves(t))


def tree_norm(t: Tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(t))


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x - y, a, b)


def estimate_smoothness(grad_after: Tree, grad_before: Tree,
                        params_after: Tree, params_before: Tree,
                        eps: float = 1e-12) -> torch.Tensor:
    """L_n (Alg. 2 line 7)."""
    dg = tree_norm(tree_sub(grad_after, grad_before))
    dx = tree_norm(tree_sub(params_after, params_before))
    return dg / torch.clamp(dx, min=eps)


def estimate_noise_sq(stoch_grads: Sequence[Tree],
                      full_grad: Tree) -> torch.Tensor:
    """sigma_n^2 (Alg. 2 line 8): variance of minibatch grads around mean."""
    return torch.stack([tree_sq_norm(tree_sub(g, full_grad))
                        for g in stoch_grads]).mean()


def estimate_grad_sq(stoch_grads: Sequence[Tree]) -> torch.Tensor:
    """G_n^2 (Alg. 2 line 9): second moment of minibatch grads."""
    return torch.stack([tree_sq_norm(g) for g in stoch_grads]).mean()


def estimates_from_grads(stoch_grads: Sequence[Tree], grad_after: Tree,
                         params_after: Tree, params_before: Tree) -> dict:
    """The (L, sigma^2, G^2) triple from its four gradient evaluations:
    ``stoch_grads`` at ``params_before`` on the estimate batches (their
    mean approximates the full gradient), ``grad_after`` at
    ``params_after`` on the first of them.  Per-client under
    ``torch.func.vmap`` over stacked trees (the cohort trainer)."""
    full = tree_map(lambda *xs: torch.stack(xs).mean(0), *stoch_grads)
    return {
        "L": estimate_smoothness(grad_after, stoch_grads[0], params_after,
                                 params_before),
        "sigma_sq": estimate_noise_sq(stoch_grads, full),
        "grad_sq": estimate_grad_sq(stoch_grads),
    }


def aggregate_estimates(per_client: Sequence[dict]) -> dict:
    """PS aggregation (Alg. 1 line 25): average each scalar over clients.

    In f32, as the reference's compiled mean computes it: the values
    summed left to right, times the f32 reciprocal of the count."""
    inv = torch.ones((), dtype=torch.float32) / len(per_client)
    out = {}
    for k in per_client[0].keys():
        total = torch.zeros((), dtype=torch.float32)
        for c in per_client:
            total = total + torch.as_tensor(float(c[k]), dtype=torch.float32)
        out[k] = float(total * inv)
    return out


def client_estimates(grad_fn: Callable[[Tree, Any], Tree],
                     params_before: Tree, params_after: Tree,
                     batches: Sequence[Any]) -> dict:
    """The (L, sigma^2, G^2) triple; the full gradient is approximated by
    the mean over ``batches``."""
    stoch = [grad_fn(params_before, b) for b in batches]
    grad_after = grad_fn(params_after, batches[0])
    return estimates_from_grads(stoch, grad_after, params_after,
                                params_before)
