"""Local-training backends.

``SequentialTrainer``: one :func:`repro_torch.fl.client.local_train` call
per client, each client drawing its minibatches from
``np.random.default_rng((seed, round, n))`` — the JAX package's host RNG
contract, so both engines see the same data order.  Results stay on the
run's device; the host merge consumes them there.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.calibration import for_dispatch
from repro_torch.fl import client as client_lib
from repro_torch.fl.client import ClientResult
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
