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
there.  Over a cohort's shards (``trainer_mesh_devices``, the JAX
package's mesh-sharded client axis) each group is padded with masked
clone clients to a multiple of the shard count, each shard gets one host
buffer and trains its contiguous client slice as its own ``vmap`` step
on its own device, and, when the collective merger merges over shards
too, the results are rows of the per-shard stacks
(:class:`~repro_torch.fl.engine.collective.CohortSlice`), which the merge
takes where they lie.
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
from repro_torch.fl.engine.collective import CohortSlice, CohortStack
from repro_torch.sharding import fl as flsh

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

    Over a cohort's shards (``self.mesh``) the group is padded to a
    multiple of the shard count with masked clones (client 0's batches,
    tau 0, so a clone keeps its starting params and its row is zeroed at
    the end), and each shard runs the steps above on its contiguous
    slice, on its device, for the group's largest tau: its kernels see
    its slice as their client axis.
    """

    def setup(self, eng) -> None:
        super().setup(eng)
        self.mesh = flsh.cohort_mesh(eng.cfg.trainer_mesh_devices,
                                     eng.device)

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
        """Returns one packed host buffer per shard (one for the whole
        group without shards) and the real clients' taus."""
        eng, cfg = self.eng, self.eng.cfg
        taus = [max(assigns[n]["tau"], 1) for n in ns]
        drawn = [eng.data.draw_round(n, seed=cfg.seed, rnd=state.round,
                                     tau=tau, batch_size=b_eff,
                                     estimate=eng.estimate,
                                     tau_pad=max(taus))
                 for n, tau in zip(ns, taus)]
        # masked clones: client 0's batches at tau 0
        clones = flsh.pad_cohort(len(ns), self.mesh) - len(ns)
        drawn += [drawn[0]] * clones
        per_client = [[d[0] for d in drawn], [d[1] for d in drawn]]
        if eng.estimate:
            per_client += [[d[2][0] for d in drawn], [d[2][1] for d in drawn]]
        chunks = flsh.mesh_size(self.mesh)
        tau_chunks = np.split(np.asarray(taus + [0] * clones), chunks)
        stacked = [stack_client_shards(a, chunks, step_leading=True)
                   for a in per_client]
        return [pack_arrays([tau_chunks[c]] + [a[c] for a in stacked])
                for c in range(chunks)], taus

    def _train_group(self, state, width: int, ns: List[int],
                     assigns: Dict[int, Assignment], prep,
                     cal) -> Dict[int, ClientResult]:
        eng, cfg = self.eng, self.eng.cfg
        packs, taus = prep
        mesh = self.mesh or flsh.CohortMesh((eng.device,))
        # each shard's buffer crosses to its device in one copy
        bufs = flsh.assemble_from_host_shards([b for b, _ in packs], mesh)
        fns = ClientFns(eng.model, width, eng.factorized, cfg.forward_impl,
                        cal)
        # masked clones start from client 0's params, at tau 0
        clones = flsh.pad_cohort(len(ns), self.mesh) - len(ns)
        client = [eng.aggregator.client_params(state, n, assigns[n])
                  for n in ns]
        client += [client[0]] * clones
        all_taus = taus + [0] * clones
        per = len(client) // len(packs)
        staged = [self._stage_shard(buf, layout,
                                    client[c * per:(c + 1) * per],
                                    min(all_taus[c * per:(c + 1) * per]),
                                    dev)
                  for c, (buf, (_, layout), dev) in enumerate(
                      zip(bufs, packs, mesh.devices))]
        obs = eng.obs
        # a shard's x as packed: (steps, C / shards, B, ...)
        lead = packs[0][1][1][3]
        with obs.wall_span("trainer.device_step", clients=len(client),
                           width=int(width), tau_pad=int(lead[0])):
            shards = [self._step_shard(fns, sh, max(taus)) for sh in staged]
            if obs.enabled:
                eng.sync_device()
        if obs.enabled:
            obs.counter_add("trainer.cohort_shape", width=int(width),
                            clients=len(client), tau_pad=int(lead[0]),
                            batch=int(lead[2]))
        rows = [row for sh in shards for row in self._estimate_shard(fns, sh)]
        finals = [sh[1] for sh in shards]
        out = {}
        merger = eng.merger
        if (self.mesh is not None and merger is not None
                and merger.mesh is not None):
            # the merge takes the rows where they lie
            stack = CohortStack(finals, len(ns), self.mesh)
            for j, n in enumerate(ns):
                out[n] = ClientResult(
                    CohortSlice(stack, j), dict(zip(EST_KEYS, rows[j][2:])),
                    rows[j][0], rows[j][1])
            return out
        for j, n in enumerate(ns):
            c, i = divmod(j, per)
            out[n] = ClientResult(
                tree_map(lambda v, i=i: v[i].to(eng.device), finals[c]),
                dict(zip(EST_KEYS, rows[j][2:])), rows[j][0], rows[j][1])
        return out

    def _stage_shard(self, buf: torch.Tensor, layout, client: list,
                     t_min: int, device):
        """One shard's packed batches ``buf`` (on ``device``) unpacked,
        and its clients' starting params stacked there: ``(tau, t_min,
        steps, estimate batches or None, params0)``, ``t_min`` its
        clients' least tau (0 with a masked clone)."""
        tau, *staged = unpack_tensors(buf, layout)
        key = self.eng.model.input_key
        batches = [{key: x, "labels": y.long()}
                   for x, y in zip(staged[0::2], staged[1::2])]
        params0 = tree_map(lambda *leaves: torch.stack(leaves).to(device),
                           *client)
        return (tau, t_min, batches[0],
                batches[1] if self.eng.estimate else None, params0)

    def _step_shard(self, fns: ClientFns, staged, steps_max: int):
        """One shard's clients trained on their device for ``steps_max``
        steps, the group's largest tau (a client past its tau, and a
        masked clone at tau 0, keeps its params; the clones' rows are
        zeroed at the end), then the losses before and after on the first
        batch.  Returns ``(params0, params, [loss_before, loss_after],
        estimate batches or None)``."""
        lr = self.eng.cfg.lr
        tau, t_min, steps, est, params0 = staged
        losses = torch.func.vmap(fns.loss)
        params = params0
        for s in range(steps_max):
            g = _cohort_grads(losses, params,
                              {k: v[s] for k, v in steps.items()})
            new = tree_map(lambda p, gg: (p - lr * gg).detach(), params, g)
            if s >= t_min:  # a client past its tau keeps its params
                live = s < tau
                new = tree_map(lambda nw, old: torch.where(
                    live.reshape((-1,) + (1,) * (nw.dim() - 1)), nw,
                    old), new, params)
            params = new
        if t_min == 0:  # zero the masked clones' rows
            live = tau > 0
            params = tree_map(lambda v: torch.where(
                live.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                torch.zeros_like(v)), params)
        first = {k: v[0] for k, v in steps.items()}
        with torch.no_grad():
            rows = [losses(params0, first), losses(params, first)]
        return params0, params, rows, est

    def _estimate_shard(self, fns: ClientFns, shard) -> list:
        """Per client of a stepped shard ``[loss_before, loss_after,
        *estimates]``: the estimates take their four gradient evaluations
        under ``vmap``; one device-to-host copy."""
        params0, params, rows, est = shard
        if est is not None:
            losses = torch.func.vmap(fns.loss)
            eb = [{k: v[i] for k, v in est.items()} for i in range(3)]
            triple = torch.func.vmap(estimator.estimates_from_grads)(
                [_cohort_grads(losses, params0, b) for b in eb],
                _cohort_grads(losses, params, eb[0]), params, params0)
            rows = rows + [triple[k] for k in EST_KEYS]
        return torch.stack(rows, 1).tolist()


def _cohort_grads(losses, params, batch):
    """Per-client gradients of the stacked clients on a stacked batch:
    autograd's of the summed per-client losses (``losses`` vmapped)."""
    return client_lib._grad(lambda p, b: losses(p, b).sum(), params, batch)


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
