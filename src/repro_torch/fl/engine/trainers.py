"""Local-training backends.

``SequentialTrainer``: one :func:`repro_torch.fl.client.local_train` call
per client, each client drawing its minibatches from
``np.random.default_rng((seed, round, n))`` — the JAX package's host RNG
contract, so both engines see the same data order.

``CohortTrainer`` is the batched backend: the clients of a cohort group
(one width, one effective batch size) are stacked on a leading client
axis and trained together, ``torch.func.vmap`` over clients of
:class:`~repro_torch.fl.client.ClientFns`' loss, one step for the whole
group per SGD step.  The composition Functions' ``vmap`` rules fold the
client axis into their kernels' own, so each kernel launches once per
layer per step, whatever the client count.  Clients with a shorter tau
are masked once they are done, so each client's update is the
sequential loop's up to float re-association.  Host batches come from
the same RNG streams and are staged a group ahead on the loader's
prefetch thread.

``ProximalTrainer`` is the FedProx local solver: the same contract with
the proximal pull ``mu * (w - w_global)`` added to every SGD step, so
FedProx drops in as a scheme bundle.

With telemetry on, each client's ``trainer.local_train`` (sequential,
proximal) and each group's ``trainer.device_step`` (cohort) is a wall
span that ends once the device has finished the work, and the cohort
trainer records ``trainer.host_stage`` (from the prefetch thread) and
one ``trainer.cohort_shape`` count per group.  The port compiles nothing
per shape, so it has no ``trainer.jit_recompiles`` counter.

Results stay on the run's device; both merge backends consume them
there.  Training a cohort across GPUs (the JAX package's mesh-sharded
client axis, ``trainer_mesh_devices > 1``) is ROADMAP queue A step 9.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import estimator
from repro_torch.core.calibration import for_dispatch
from repro_torch.core.estimator import tree_map
from repro_torch.data.streaming import (pack_arrays, round_batch_indices,
                                        stack_client_shards, unpack_tensors)
from repro_torch.fl import client as client_lib
from repro_torch.fl.client import ClientFns, ClientResult
from repro_torch.fl.engine.base import Assignment, LocalTrainer

EST_KEYS = ("L", "sigma_sq", "grad_sq")


class SequentialTrainer(LocalTrainer):
    """One ``local_train`` call per client, in assignment order."""

    def train_all(self, state, assigns: Dict[int, Assignment],
                  ) -> Dict[int, ClientResult]:
        eng = self.eng
        obs = eng.obs
        cal = for_dispatch(eng.cfg, eng.device)
        out = {}
        for n, a in assigns.items():
            params = eng.aggregator.client_params(state, n, a)
            with obs.wall_span("trainer.local_train", client=int(n),
                               width=int(a["width"]), tau=int(a["tau"])):
                out[n] = client_lib.local_train(
                    eng.model, params, a["width"], a["tau"],
                    eng.parts_x[n], eng.parts_y[n], eng.cfg.lr,
                    np.random.default_rng((eng.cfg.seed, state.round, n)),
                    eng.cfg.batch_size, factorized=eng.factorized,
                    estimate=eng.estimate,
                    forward_impl=eng.cfg.forward_impl,
                    calibration=cal,
                )
                if obs.enabled:
                    eng.sync_device()
        return out


class CohortTrainer(LocalTrainer):
    """Batched backend: each cohort group trains in one batched step.

    A group is the clients of one ``(width, min(batch_size, samples))``.
    Its step count is its largest tau (the JAX package also pads the
    client count and tau to powers of two, which bounds its recompiles;
    the port compiles nothing, so it trains the group's real clients for
    its largest tau, and each real client's result is the same).  Each
    step takes the per-client losses under ``torch.func.vmap``, the
    per-client gradients as autograd's of their sum (the clients are
    independent), and the SGD update, a client past its tau keeping its
    params.  Loss before and after are one no-grad ``vmap`` forward each
    on the first batch; the estimates take their four gradient
    evaluations the same way and :func:`repro_torch.core.estimator.
    estimates_from_grads` under ``vmap``.
    """

    def train_all(self, state, assigns: Dict[int, Assignment],
                  ) -> Dict[int, ClientResult]:
        eng = self.eng
        # measured (or pinned) here, so no calibration runs under vmap
        cal = for_dispatch(eng.cfg, eng.device)
        groups: Dict[tuple, List[int]] = {}
        for n, a in assigns.items():
            b_eff = min(eng.cfg.batch_size, eng.data.num_samples(n))
            groups.setdefault((a["width"], b_eff), []).append(n)
        specs = list(groups.items())
        # host batches of a group are gathered on the prefetch thread one
        # group ahead of the device step
        prepared = eng.data.prefetch(
            specs, lambda s: self._prepare_group(state, s[0][1], s[1],
                                                 assigns))
        results: Dict[int, ClientResult] = {}
        try:
            for ((width, _), ns), prep in zip(specs, prepared):
                results.update(self._train_group(state, width, ns, assigns,
                                                 prep, cal))
        finally:
            # a failing step must not leave the prefetch worker blocked
            prepared.close()
        return {n: results[n] for n in assigns}

    def _prepare_group(self, state, b_eff: int, ns: List[int],
                       assigns: Dict[int, Assignment]):
        """One group's host batches (numpy only: runs on the prefetch
        thread), drawn as the sequential path draws them: tau training
        batches padded to the group's largest tau with the last one, then
        3 estimate batches.  Stacked with the step axis first, (steps, C,
        B, ...), and packed with the clients' taus into one buffer for
        one host-to-device copy."""
        # the span lands from the prefetch thread; the recorder's lock
        # makes that safe
        with self.eng.obs.wall_span("trainer.host_stage", clients=len(ns),
                                    batch=int(b_eff)):
            return self._prepare_group_inner(state, b_eff, ns, assigns)

    def _prepare_group_inner(self, state, b_eff: int, ns: List[int],
                             assigns: Dict[int, Assignment]):
        eng, cfg = self.eng, self.eng.cfg
        taus = [max(assigns[n]["tau"], 1) for n in ns]
        drawn = [eng.data.draw_round(n, seed=cfg.seed, rnd=state.round,
                                     tau=tau, batch_size=b_eff,
                                     estimate=eng.estimate,
                                     tau_pad=max(taus))
                 for n, tau in zip(ns, taus)]
        per_client = [[d[0] for d in drawn], [d[1] for d in drawn]]
        if eng.estimate:
            per_client += [[d[2][0] for d in drawn], [d[2][1] for d in drawn]]
        return pack_arrays([np.asarray(taus)]
                           + [stack_client_shards(a, step_leading=True)
                              for a in per_client]), taus

    def _train_group(self, state, width: int, ns: List[int],
                     assigns: Dict[int, Assignment], prep,
                     cal) -> Dict[int, ClientResult]:
        eng, cfg = self.eng, self.eng.cfg
        (buf, layout), taus = prep
        tau, *staged = unpack_tensors(torch.from_numpy(buf).to(eng.device),
                                      layout)
        key = eng.model.input_key
        batches = [{key: x, "labels": y.long()}
                   for x, y in zip(staged[0::2], staged[1::2])]
        steps, est = batches[0], batches[1] if eng.estimate else None

        fns = ClientFns(eng.model, width, eng.factorized, cfg.forward_impl,
                        cal)
        losses = torch.func.vmap(fns.loss)

        def grads(params, batch):
            """Per-client gradients of the stacked clients on a stacked
            batch: autograd's of the summed per-client losses."""
            return client_lib._grad(lambda p, b: losses(p, b).sum(), params,
                                    batch)

        params0 = tree_map(lambda *leaves: torch.stack(leaves),
                           *[eng.aggregator.client_params(state, n,
                                                          assigns[n])
                             for n in ns])
        params = params0
        obs = eng.obs
        # (steps, C, B, ...): the group's largest tau, its clients (the
        # port pads neither), the batch
        lead = steps[key].shape
        with obs.wall_span("trainer.device_step", clients=int(lead[1]),
                           width=int(width), tau_pad=int(lead[0])):
            for s in range(max(taus)):
                g = grads(params, {k: v[s] for k, v in steps.items()})
                new = tree_map(lambda p, gg: (p - cfg.lr * gg).detach(),
                               params, g)
                if s >= min(taus):  # a client past its tau keeps its params
                    live = s < tau
                    new = tree_map(lambda nw, old: torch.where(
                        live.reshape((-1,) + (1,) * (nw.dim() - 1)), nw,
                        old), new, params)
                params = new

            first = {k: v[0] for k, v in steps.items()}
            with torch.no_grad():
                loss_b, loss_a = losses(params0, first), losses(params,
                                                                first)
            if obs.enabled:
                eng.sync_device()
        if obs.enabled:
            obs.counter_add("trainer.cohort_shape", width=int(width),
                            clients=int(lead[1]), tau_pad=int(lead[0]),
                            batch=int(lead[2]))
        rows = [loss_b, loss_a]
        if est is not None:
            eb = [{k: v[i] for k, v in est.items()} for i in range(3)]
            triple = torch.func.vmap(estimator.estimates_from_grads)(
                [grads(params0, b) for b in eb], grads(params, eb[0]),
                params, params0)
            rows += [triple[k] for k in EST_KEYS]
        rows = torch.stack(rows, 1).tolist()  # one device-to-host copy
        out = {}
        for j, n in enumerate(ns):
            out[n] = ClientResult(
                tree_map(lambda v, j=j: v[j], params),
                dict(zip(EST_KEYS, rows[j][2:])), rows[j][0], rows[j][1])
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
        obs = eng.obs
        mu = cfg.prox_mu
        cal = for_dispatch(cfg, eng.device)
        out: Dict[int, ClientResult] = {}
        for n, a in assigns.items():
            fns = ClientFns(eng.model, a["width"], eng.factorized,
                            cfg.forward_impl, cal)
            with obs.wall_span("trainer.local_train", client=int(n),
                               width=int(a["width"]), tau=int(a["tau"])):
                out[n] = self._train_one(state, n, a, fns, mu)
                if obs.enabled:
                    eng.sync_device()
        return out

    def _train_one(self, state, n: int, a: Assignment, fns: ClientFns,
                   mu: float) -> ClientResult:
        eng, cfg = self.eng, self.eng.cfg
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
        return ClientResult(params, est, fns.value(anchor, first),
                            fns.value(params, first))
