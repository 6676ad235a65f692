"""Client-side procedure (paper Alg. 2), in PyTorch.

A client receives (basis, reduced coefficient, tau), runs tau local SGD
iterations over its data directly on the factors under autograd,
estimates (L, sigma^2, G^2) and returns updated tensors + estimates.  How
each layer weight is *applied* inside the loss is the ``forward_impl``
knob (see ``FLModelDef.prepare_weights``).  Minibatch indices come from
the numpy generator handed in, drawn exactly as the JAX package draws
them, and the batches are moved to the device the params live on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core import estimator
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.data.streaming import to_batch
from repro_torch.fl.models import FLModelDef

Tensor = torch.Tensor


def data_batch(model: FLModelDef, x, y, idx, device) -> Dict[str, Tensor]:
    return to_batch(model.input_key, x[idx], y[idx], device)


def _ce(logits: Tensor, labels: Tensor) -> Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def _grad(loss_fn: Callable, params, batch):
    """Gradient tree of ``loss_fn(params, batch)`` w.r.t. every leaf."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(loss_fn(p, batch), tree_leaves(p)))
    return tree_map(lambda _: next(grads), p)


@dataclasses.dataclass(frozen=True)
class ClientFns:
    """The loss, gradient and SGD step of one (model, width, impl)."""

    model: FLModelDef
    width: int
    factorized: bool
    forward_impl: str = "auto"
    calibration: Any = None

    def loss(self, params, batch) -> Tensor:
        w = (self.model.prepare_weights(params, self.width, batch,
                                        self.forward_impl, self.calibration)
             if self.factorized else dict(params))
        logits = self.model.forward(w, self.width, batch)
        return _ce(logits, batch["labels"])

    def value(self, params, batch) -> float:
        with torch.no_grad():
            return float(self.loss(params, batch))

    def grad(self, params, batch):
        return _grad(self.loss, params, batch)

    def sgd_step(self, params, batch, lr: float):
        g = self.grad(params, batch)
        return tree_map(lambda p, gg: (p - lr * gg).detach(), params, g)


@dataclasses.dataclass
class ClientResult:
    params: Any  # updated reduced factors (or dense weights), on the device
    estimates: Dict[str, float]
    loss_before: float
    loss_after: float

    def host_params(self) -> Any:
        """Params copied to host numpy, for the checkpoint codec; during a
        run results stay on the device.  A sharded cohort trainer hands
        the collective merger rows of its per-shard stacks (``params``
        with a ``materialize``), which this materializes first."""
        mat = getattr(self.params, "materialize", None)
        params = mat() if mat is not None else self.params
        return tree_map(lambda t: t.detach().cpu().numpy(), params)


def local_train(
    model: FLModelDef,
    reduced_params: Any,
    width: int,
    tau: int,
    x, y,
    lr: float,
    rng: np.random.Generator,
    batch_size: int = 16,
    factorized: bool = True,
    estimate: bool = True,
    forward_impl: str = "auto",
    calibration=None,
) -> ClientResult:
    """tau local SGD iterations (Alg. 2 lines 4-9) on the device the
    params live on.

    ``x``/``y`` are the client's host shards; ``rng`` draws ``tau``
    minibatch index vectors, then 3 estimate batches, as in the JAX
    package.  ``forward_impl`` selects the factorized compute path
    (``calibration`` carries an ``FLConfig`` pin; None = the per-process
    measurement).  Ignored when ``factorized=False``.
    """
    fns = ClientFns(model, width, factorized, forward_impl, calibration)
    device = tree_leaves(reduced_params)[0].device
    params0 = reduced_params
    params = params0
    n = len(y)
    first_batch = None
    for _ in range(max(tau, 1)):
        idx = rng.integers(0, n, min(batch_size, n))
        batch = data_batch(model, x, y, idx, device)
        if first_batch is None:
            first_batch = batch
        params = fns.sgd_step(params, batch, lr)

    est = {}
    loss_b = fns.value(params0, first_batch)
    loss_a = fns.value(params, first_batch)
    if estimate:
        batches = [
            data_batch(model, x, y, rng.integers(0, n, min(batch_size, n)),
                       device)
            for _ in range(3)
        ]
        est = estimator.client_estimates(fns.grad, params0, params, batches)
        est = {k: float(v) for k, v in est.items()}
    return ClientResult(params, est, loss_b, loss_a)
