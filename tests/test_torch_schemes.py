"""The paper's baselines, FedProx and the semi-async loop against the JAX
package, end to end, on both merge backends.

As in ``test_torch_engine.py``: both engines start from the reference's
own initial weights (carried across with ``from_jax_params``) and draw
every minibatch from the same numpy streams, so widths, τs, block ids,
traffic, makespan, average wait and staleness must be equal; accuracy
agrees within 2 test samples, client estimates within ``EST_TOL``
relative, and the final parameters within ``PARAM_ATOL``.  The reference
merges with its host rules (its collective backend equals them bit for
bit on one device, which its own tests pin); each reference run is
shared by the port's host and collective cases.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl.engine import ProximalTrainer, SemiAsyncRoundLoop
from test_torch_engine import EST_TOL, PIN, _record, _rel
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

BASE = dict(num_clients=8, clients_per_round=3, eval_every=1, **PIN)
ASYNC = dict(round_mode="semi_async", async_k=2)
# final parameters after 3-4 rounds of float32 SGD on both frameworks
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def reference():
    """``run(scheme, rounds, **knobs)`` -> (initial params as numpy, the
    recorded assignments and estimates, the history, final params as
    numpy), each run once."""
    setup = j_setup(num_clients=8)
    cache = {}

    def run(scheme, rounds, **knobs):
        key = (scheme, rounds, tuple(sorted(knobs.items())))
        if key not in cache:
            jr = j_build(scheme, *setup, cfg=JConfig(
                agg_backend="host", **BASE, **knobs))
            init = jax.device_get(jr.params)
            log = _record(jr)
            hist = jr.run(rounds)
            cache[key] = (init, log, hist, jax.device_get(jr.params))
        return cache[key]

    return run


@pytest.fixture(scope="module")
def setup():
    return t_setup(num_clients=8, device="cpu")


def _port(setup, scheme, rounds, init, backend, **knobs):
    tr = t_build(scheme, *setup, device="cpu", cfg=TConfig(
        agg_backend=backend, **BASE, **knobs))
    tr.state = dataclasses.replace(tr.state,
                                   params=from_jax_params(init, "cpu"))
    log = _record(tr)
    tr.run(rounds)
    return tr, log


def _assert_params_close(want, got, path=()):
    """Two nested-dict parameter trees (numpy leaves) leaf by leaf."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _assert_params_close(want[k], got[k], path + (k,))
        return
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=PARAM_ATOL, err_msg=str(path))


def _check(ref, port, setup, est_tol=EST_TOL):
    _, jlog, jh, jfinal = ref
    tr, tlog = port
    th = tr.history
    n_test = int(setup[3]["labels"].shape[0])
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        assert (a.round, a.wall_time, a.traffic_bytes, a.makespan,
                a.avg_wait, a.mean_tau, a.stale, a.up_bytes,
                a.down_bytes) == \
            (b.round, b.wall_time, b.traffic_bytes, b.makespan,
             b.avg_wait, b.mean_tau, b.stale, b.up_bytes, b.down_bytes)
        assert abs(a.accuracy - b.accuracy) <= 2.0 / n_test
    assert len(jlog) == len(tlog)
    for ra, rb in zip(jlog, tlog):
        assert ra["assign"] == rb["assign"]
        assert ra["est"].keys() == rb["est"].keys()
        for n, ea in ra["est"].items():
            for k, va in ea.items():
                assert _rel(va, rb["est"][n][k]) <= est_tol, (n, k)
    _assert_params_close(jfinal, to_numpy(tr.params))


# flanc runs rank_space on the host backend and the pinned auto (the
# fused head, conv_rank and compose) on the collective one, so both of its
# kernel mixes are held; the dense schemes run no kernel
@pytest.mark.parametrize("scheme,backend,impl", [
    ("adp", "host", "materialize"),
    ("adp", "collective", "materialize"),
    ("heterofl", "host", "materialize"),
    ("heterofl", "collective", "materialize"),
    ("fedprox", "host", "materialize"),
    ("fedprox", "collective", "materialize"),
    ("flanc", "host", "rank_space"),
    ("flanc", "collective", "auto"),
])
def test_scheme_matches_reference(scheme, backend, impl, reference, setup):
    ref = reference(scheme, 3, forward_impl=impl)
    port = _port(setup, scheme, 3, ref[0], backend, forward_impl=impl)
    _check(ref, port, setup)
    widths = {w for r in port[1] for (w, *_rest) in r["assign"].values()}
    if scheme in ("heterofl", "flanc"):
        assert len(widths) > 1  # the tiers give several widths


@pytest.mark.parametrize("backend", ["host", "collective"])
@pytest.mark.parametrize("scheme", ["heroes", "fedavg"])
def test_semi_async_matches_reference(scheme, backend, reference, setup):
    ref = reference(scheme, 4, forward_impl="rank_space", **ASYNC)
    port = _port(setup, scheme, 4, ref[0], backend,
                 forward_impl="rank_space", **ASYNC)
    _check(ref, port, setup)
    assert any(h.stale > 0 for h in port[0].history)
    assert isinstance(port[0].loop, SemiAsyncRoundLoop)


@pytest.mark.parametrize("backend", ["host", "collective"])
@pytest.mark.parametrize("scheme", ["heroes", "fedavg"])
def test_sample_weighted_matches_reference(scheme, backend, reference,
                                           setup):
    ref = reference(scheme, 3, forward_impl="rank_space",
                    sample_weighted=True)
    port = _port(setup, scheme, 3, ref[0], backend,
                 forward_impl="rank_space", sample_weighted=True)
    _check(ref, port, setup)


def test_fedprox_proximal_term_matches_reference(reference, setup):
    """At prox_mu = 1 the proximal pull moves the final parameters well
    past ``PARAM_ATOL`` from FedAvg's, so a local solver without it
    fails the parameter check."""
    ref = reference("fedprox", 3, forward_impl="materialize", prox_mu=1.0)
    port = _port(setup, "fedprox", 3, ref[0], "host",
                 forward_impl="materialize", prox_mu=1.0)
    _check(ref, port, setup)
    assert isinstance(port[0].trainer, ProximalTrainer)
    fedavg = reference("fedavg", 3, forward_impl="materialize")[3]
    gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(jax.tree_util.tree_leaves(fedavg),
                              jax.tree_util.tree_leaves(ref[3])))
    assert gap > 100 * PARAM_ATOL


def test_fedprox_with_mu_zero_is_fedavg(setup):
    """The fedprox scheme at ``prox_mu=0`` takes FedAvg's local steps:
    the states agree bit for bit."""
    runs = [t_build(scheme, *setup, device="cpu", cfg=TConfig(
        agg_backend="host", prox_mu=0.0, **BASE))
        for scheme in ("fedprox", "fedavg")]
    for r in runs:
        r.run(2)
    assert isinstance(runs[0].trainer, ProximalTrainer)
    assert runs[0].history == runs[1].history
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        assert torch.equal(a, b)
