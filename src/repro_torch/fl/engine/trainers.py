"""Local-training backends.

``SequentialTrainer``: one :func:`repro_torch.fl.client.local_train` call
per client, each client drawing its minibatches from
``np.random.default_rng((seed, round, n))`` — the JAX package's host RNG
contract, so both engines see the same data order.

``ProximalTrainer`` is the FedProx local solver: the same contract with
the proximal pull ``mu * (w - w_global)`` added to every SGD step, so
FedProx drops in as a scheme bundle.

Results stay on the run's device; both merge backends consume them
there.  The JAX package's batched ``CohortTrainer`` is not ported yet
(ROADMAP queue A step 7).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import estimator
from repro_torch.core.calibration import for_dispatch
from repro_torch.core.estimator import tree_map
from repro_torch.data.streaming import round_batch_indices
from repro_torch.fl import client as client_lib
from repro_torch.fl.client import ClientFns, ClientResult
from repro_torch.fl.engine.base import Assignment, LocalTrainer


class SequentialTrainer(LocalTrainer):
    """One ``local_train`` call per client, in assignment order."""

    def train_all(self, state, assigns: Dict[int, Assignment],
                  ) -> Dict[int, ClientResult]:
        eng = self.eng
        cal = for_dispatch(eng.cfg, eng.device)
        out = {}
        for n, a in assigns.items():
            params = eng.aggregator.client_params(state, n, a)
            out[n] = client_lib.local_train(
                eng.model, params, a["width"], a["tau"],
                eng.parts_x[n], eng.parts_y[n], eng.cfg.lr,
                np.random.default_rng((eng.cfg.seed, state.round, n)),
                eng.cfg.batch_size, factorized=eng.factorized,
                estimate=eng.estimate,
                forward_impl=eng.cfg.forward_impl,
                calibration=cal,
            )
        return out


class ProximalTrainer(LocalTrainer):
    """FedProx local solver: SGD on ``f(w) + (mu/2) ||w - w_global||^2``.

    The sequential contract (minibatch indices from the same
    ``round_batch_indices`` stream: tau training draws, then 3 estimate
    draws when the scheme ships estimates), with the proximal pull toward
    the received global view added to every step; ``mu = 0`` gives
    FedAvg's local update.  ``mu`` is ``FLConfig.prox_mu``.
    The gradient is autograd's through :class:`ClientFns`' loss (the
    sequential trainer's), the proximal step plain tensor arithmetic.
    """

    def train_all(self, state, assigns: Dict[int, Assignment],
                  ) -> Dict[int, ClientResult]:
        eng, cfg = self.eng, self.eng.cfg
        mu = cfg.prox_mu
        cal = for_dispatch(cfg, eng.device)
        out: Dict[int, ClientResult] = {}
        for n, a in assigns.items():
            fns = ClientFns(eng.model, a["width"], eng.factorized,
                            cfg.forward_impl, cal)
            anchor = eng.aggregator.client_params(state, n, a)
            nsamp = eng.data.num_samples(n)
            idx, est_idx = round_batch_indices(
                cfg.seed, state.round, n, nsamp, max(a["tau"], 1),
                min(cfg.batch_size, nsamp), estimate=eng.estimate)
            params, first = anchor, None
            for i in idx:
                batch = eng.data.gather(n, i)
                if first is None:
                    first = batch
                g = fns.grad(params, batch)
                params = tree_map(
                    lambda p, w0, gg: (p - cfg.lr * (gg + mu * (p - w0)))
                    .detach(), params, anchor, g)
            est: Dict[str, float] = {}
            if est_idx is not None:
                est = estimator.client_estimates(
                    fns.grad, anchor, params,
                    [eng.data.gather(n, i) for i in est_idx])
                est = {k: float(v) for k, v in est.items()}
            out[n] = ClientResult(params, est, fns.value(anchor, first),
                                  fns.value(params, first))
        return out
