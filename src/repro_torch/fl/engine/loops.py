"""Round event loop over the virtual clock.

``SyncRoundLoop`` is the paper's round (Alg. 1 / Eq. 19): sample K
clients, train all, aggregate, charge the makespan ``max_n (tau mu + nu)``
to the wall clock.  A pure state transition: ``run_round(state)`` returns
``(state', log)`` built with ``dataclasses.replace``.  The time model's
per-round noise streams are keyed by ``het.round``, which the loop
derives from the state (``state.round + 1`` while that round runs).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.fl.engine.base import RoundLoop
from repro_torch.fl.types import RoundLog, ServerState


class SyncRoundLoop(RoundLoop):
    """Synchronous makespan round (paper Eq. 19)."""

    def run_round(self, state: ServerState) -> Tuple[ServerState, RoundLog]:
        eng = self.eng
        cfg = eng.cfg
        eng.het.round = state.round + 1  # per-round time-noise stream key
        clients = eng.sample_clients(state, cfg.clients_per_round)
        if not clients:
            raise RuntimeError(
                "participation scheduler returned an empty cohort "
                f"(scheduler={type(eng.sampler).__name__}, "
                f"num_clients={cfg.num_clients})")
        state, assigns = eng.assignment.assign(state, clients)
        results = eng.trainer.train_all(state, assigns)
        times = {}
        traffic = state.traffic
        up = 0.0
        for n, a in assigns.items():
            mu = eng.het.iter_time(n, eng.flops_per_iter(a["width"]))
            b = eng.payload.bytes(a)
            nu = eng.het.upload_time(n, b)
            times[n] = a["tau"] * mu + nu
            traffic += 2 * b  # down + up
            up += b  # symmetric payloads: uplink == downlink == b
        state = eng.aggregator.aggregate(
            dataclasses.replace(state, traffic=traffic,
                                traffic_up=state.traffic_up + up,
                                traffic_down=state.traffic_down + up),
            results, assigns)
        makespan = max(times.values())
        wait = float(np.mean([makespan - t for t in times.values()]))
        state = dataclasses.replace(state, wall=state.wall + makespan,
                                    round=state.round + 1)
        acc = None
        if state.round % cfg.eval_every == 0 or state.round == 1:
            acc = eng.aggregator.evaluate(state)
        log = RoundLog(state.round, state.wall, state.traffic, makespan, wait,
                       float(np.mean([a["tau"] for a in assigns.values()])),
                       acc, up_bytes=up, down_bytes=up)
        state = dataclasses.replace(state, history=state.history + (log,))
        return state, log
