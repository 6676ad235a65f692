"""Round event loops over the virtual clock.

``SyncRoundLoop`` is the paper's round (Alg. 1 / Eq. 19): sample K
clients, train all, aggregate, charge the makespan ``max_n (tau mu + nu)``
to the wall clock.

``SemiAsyncRoundLoop`` keeps up to M clients in flight and aggregates as
soon as the fastest K of them finish.  Stragglers stay in flight across
aggregation events and merge later with a staleness-discounted weight
``decay ** staleness`` (their update was computed against an older
global model), the FedAsync/FedBuff-style rule adapted to every
scheme's aggregator.  The wall clock advances event by event to the
K-th completion, so fast clients stop paying for slow ones.

Both loops are pure state transitions: ``run_round(state)`` returns
``(state', log)`` built with ``dataclasses.replace``.  The time model's
per-round noise streams are keyed by ``het.round``, which the loops
derive from the state (``state.round + 1`` while that round runs).

Both loops hand the same ``weights`` dict to ``aggregator.aggregate``,
so semi-async events and ``FLConfig.sample_weighted`` rounds use the
same merge as synchronous rounds, on either backend.
``sample_weighted`` turns per-client sample counts into blend weights
``K * s_n / sum(s)``, which makes the cohort mean the sample-weighted
mean — exactly — for the global-mean rules; the weights can exceed 1, so
partitioned rules (per-block, per-region, per-width subsets) see an
extrapolated weighting.  Semi-async multiplies them into the staleness
discounts.

With telemetry on (``eng.obs``, :mod:`repro_torch.obs`) each dispatched
client records its ``client.train`` and ``client.upload`` spans on the
virtual clock and its bytes under ``traffic.up`` / ``traffic.down`` by
width; each merge an ``aggregate.merge`` wall span, which ends after the
device has finished the merge; each round the ``round.makespan`` and
``round.wait`` histograms and a ``round.aggregate`` event; semi-async
events also ``staleness`` per merged result and the ``loop.in_flight``
gauge.  Telemetry only reads what the loops computed: nothing of it
enters the state, so histories and checkpoints are the same with it off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.fl.engine.base import RoundLoop
from repro_torch.fl.engine.collective import CohortSlice, plain_params
from repro_torch.fl.types import InFlight, RoundLog, ServerState


def _sample_weights(eng, clients) -> Dict[int, float]:
    """Sample-count weights ``K * s_n / sum(s)`` for one merge cohort.

    Through the blend ``w * update + (1 - w) * global`` these reduce the
    plain cohort mean to ``sum(s_n * u_n) / sum(s_n)``, because the blend
    residuals ``(1 - w_n)`` cancel over the cohort.  Not clamped to
    [0, 1].
    """
    s = np.array([eng.data.num_samples(n) for n in clients], np.float64)
    w = s * (len(clients) / s.sum())
    return {n: float(wn) for n, wn in zip(clients, w)}


def _charge(eng, n: int, a) -> Tuple[float, float, float]:
    """(iteration time mu, one-way bytes b, upload time nu) of client
    ``n``'s assignment ``a`` under the round's time model."""
    mu = eng.het.iter_time(n, eng.flops_per_iter(a["width"]))
    b = eng.payload.bytes(a)
    return mu, b, eng.het.upload_time(n, b)


def _record_dispatch(obs, state: ServerState, n: int, a, t_train: float,
                     t_up: float, b: float) -> None:
    """Client ``n``'s train and upload spans on the virtual clock (from
    ``state.wall``) and its bytes each way, by width."""
    obs.span("client.train", state.wall, t_train, client=int(n),
             width=int(a["width"]), tau=int(a["tau"]),
             round=state.round + 1)
    obs.span("client.upload", t_train, t_up, client=int(n), bytes=b,
             round=state.round + 1)
    obs.counter_add("traffic.up", b, width=int(a["width"]))
    obs.counter_add("traffic.down", b, width=int(a["width"]))


def _merge(eng, state: ServerState, results, assigns, weights,
           **attrs) -> ServerState:
    """``eng.aggregator.aggregate`` inside the ``aggregate.merge`` wall
    span, which (telemetry on) ends once the device has the merge done."""
    obs = eng.obs
    with obs.wall_span("aggregate.merge", clients=len(results), **attrs):
        state = eng.aggregator.aggregate(state, results, assigns,
                                         weights=weights)
        if obs.enabled:
            eng.sync_device()
    return state


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
        obs = eng.obs
        times = {}
        traffic = state.traffic
        up = 0.0
        for n, a in assigns.items():
            mu, b, nu = _charge(eng, n, a)
            times[n] = a["tau"] * mu + nu
            traffic += 2 * b  # down + up
            up += b  # symmetric payloads: uplink == downlink == b
            if obs.enabled:
                t_train = state.wall + a["tau"] * mu
                _record_dispatch(obs, state, n, a, t_train, t_train + nu, b)
        weights = (_sample_weights(eng, list(results))
                   if cfg.sample_weighted else None)
        state = _merge(eng, dataclasses.replace(
            state, traffic=traffic, traffic_up=state.traffic_up + up,
            traffic_down=state.traffic_down + up),
            results, assigns, weights)
        makespan = max(times.values())
        wait = float(np.mean([makespan - t for t in times.values()]))
        state = dataclasses.replace(state, wall=state.wall + makespan,
                                    round=state.round + 1)
        acc = None
        if state.round % cfg.eval_every == 0 or state.round == 1:
            acc = eng.aggregator.evaluate(state)
        if obs.enabled:
            obs.observe("round.makespan", makespan)
            obs.observe("round.wait", wait)
            obs.event("round.aggregate", state.wall, round=state.round,
                      clients=len(results))
        log = RoundLog(state.round, state.wall, state.traffic, makespan, wait,
                       float(np.mean([a["tau"] for a in assigns.values()])),
                       acc, up_bytes=up, down_bytes=up)
        state = dataclasses.replace(state, history=state.history + (log,))
        return state, log


class SemiAsyncRoundLoop(RoundLoop):
    """Aggregate the fastest K of M in-flight clients per event.

    One ``run_round`` call = one aggregation event.  Training results are
    computed eagerly at dispatch against the then-current global state —
    exactly what a straggler's update would contain when it finally
    lands — and merged with weight ``staleness_decay ** staleness``.
    Dispatch records live in ``state.in_flight``, with their results on
    the run's device, and are checkpointed with the state: the codec
    (:mod:`repro_torch.fl.engine.state`) copies each result's params to
    the host (``ClientResult.host_params``) and a restore puts them back
    on the device, so a resumed run merges the same stragglers.
    """

    def setup(self, eng) -> None:
        super().setup(eng)
        cfg = eng.cfg
        self.k = cfg.async_k or max(1, cfg.clients_per_round // 2)
        self.decay = cfg.staleness_decay

    def _dispatch(self, state: ServerState,
                  clients: List[int]) -> ServerState:
        eng = self.eng
        state, assigns = eng.assignment.assign(state, clients)
        results = eng.trainer.train_all(state, assigns)
        obs = eng.obs
        traffic = state.traffic
        up = 0.0
        new = []
        for n, a in assigns.items():
            mu, b, nu = _charge(eng, n, a)
            traffic += 2 * b
            up += b
            finish = state.wall + a["tau"] * mu + nu
            new.append(InFlight(n, a, results[n], finish, state.round))
            if obs.enabled:
                _record_dispatch(obs, state, n, a, state.wall + a["tau"] * mu,
                                 finish, b)
        return dataclasses.replace(state, traffic=traffic,
                                   traffic_up=state.traffic_up + up,
                                   traffic_down=state.traffic_down + up,
                                   in_flight=state.in_flight + tuple(new))

    def run_round(self, state: ServerState) -> Tuple[ServerState, RoundLog]:
        eng = self.eng
        cfg = eng.cfg
        eng.het.round = state.round + 1
        up0, down0 = state.traffic_up, state.traffic_down
        busy = {t.client for t in state.in_flight}
        need = cfg.clients_per_round - len(state.in_flight)
        if need > 0:
            # the eligible pool can be empty (every client in flight):
            # skip the dispatch rather than advance the policy on []
            newly = eng.sample_clients(state, need, exclude=busy)
            if newly:
                state = self._dispatch(state, newly)
        if not state.in_flight:
            raise RuntimeError(
                "semi-async round with no dispatchable clients "
                f"(num_clients={cfg.num_clients}, "
                f"clients_per_round={cfg.clients_per_round})")

        # stable sort: ties keep dispatch order, so event composition is
        # reproducible
        flight = sorted(state.in_flight, key=lambda t: t.finish)
        k = min(self.k, len(flight))
        t_k = flight[k - 1].finish
        done = [t for t in flight if t.finish <= t_k]
        remaining = tuple(t for t in flight if t.finish > t_k)

        results = {t.client: t.result for t in done}
        assigns = {t.client: t.assign for t in done}
        stale = sum(1 for t in done if state.round > t.dispatched)
        # all-fresh events take the unweighted merge
        weights = None if stale == 0 else {
            t.client: self.decay ** (state.round - t.dispatched)
            for t in done}
        if cfg.sample_weighted:
            sw = _sample_weights(eng, list(results))
            weights = sw if weights is None else \
                {n: sw[n] * weights[n] for n in sw}
        obs = eng.obs
        if obs.enabled:
            for t in done:
                obs.observe("staleness", float(state.round - t.dispatched))
        state = _merge(eng, state, results, assigns, weights, stale=stale)
        # stragglers must not keep a sharded trainer's per-shard stacks
        # alive across events: their results become plain tensors now,
        # so each stack dies with its event
        remaining = tuple(
            dataclasses.replace(t, result=dataclasses.replace(
                t.result, params=plain_params(t.result.params)))
            if isinstance(t.result.params, CohortSlice) else t
            for t in remaining)

        makespan = t_k - state.wall  # time since the previous aggregation
        wait = float(np.mean([t_k - t.finish for t in done]))
        state = dataclasses.replace(state, wall=t_k, round=state.round + 1,
                                    in_flight=remaining)
        acc = None
        if state.round % cfg.eval_every == 0 or state.round == 1:
            acc = eng.aggregator.evaluate(state)
        if obs.enabled:
            obs.observe("round.makespan", makespan)
            obs.observe("round.wait", wait)
            obs.event("round.aggregate", state.wall, round=state.round,
                      clients=len(results), stale=stale,
                      in_flight=len(remaining))
            obs.gauge_set("loop.in_flight", len(remaining))
        log = RoundLog(state.round, state.wall, state.traffic, makespan, wait,
                       float(np.mean([a["tau"] for a in assigns.values()])),
                       acc, stale=stale,
                       up_bytes=state.traffic_up - up0,
                       down_bytes=state.traffic_down - down0)
        state = dataclasses.replace(state, history=state.history + (log,))
        return state, log
