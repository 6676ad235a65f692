"""The port's aggregation functions against the JAX package, and the
default ``agg_backend="collective"`` against ``"host"``.

The aggregation functions get the same seeded numpy inputs on both sides.
``aggregate_coefficient`` adds the same float32 values in the same order
on both sides, so it is held to tolerance 0; ``aggregate_basis`` is a
mean that may sum in another order and is held to ``atol=1e-6``.  On one
device the reference's collective backend equals its host rules bit for
bit, so the port's default backend must give the host backend's final
state bit for bit on every scheme.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ja
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro.fl import simulation as jsim
from repro_torch.core import aggregation as ta
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import RoundLog
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl import simulation as tsim
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

MEAN_ATOL = 1e-6  # means may sum in another order across frameworks
SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "fedprox", "heroes")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cohort(seed=0, k=4, num_blocks=9, r=8, o=6):
    """Per-client (blocks (m_k, R, O), ids) and a global coefficient."""
    rng = np.random.default_rng(seed)
    blocks, ids = [], []
    for _ in range(k):
        m = int(rng.integers(1, num_blocks + 1))
        i = rng.choice(num_blocks, m, replace=False)
        ids.append(i.astype(np.int64))
        blocks.append(rng.standard_normal((len(i), r, o)).astype(np.float32))
    prev = rng.standard_normal((num_blocks, r, o)).astype(np.float32)
    return blocks, ids, prev


@pytest.mark.parametrize("weights", [None, (0.0, 1.0, 0.5, 0.25),
                                     (1.0, 1.0, 1.0, 1.0),
                                     (0.0, 0.0, 0.0, 0.0)],
                         ids=["none", "mixed", "ones", "zeros"])
def test_aggregate_coefficient_matches_reference(weights):
    blocks, ids, prev = _cohort(5)
    got = ta.aggregate_coefficient(_t(prev), [_t(b) for b in blocks], ids,
                                   weights=weights)
    want = ja.aggregate_coefficient(jnp.asarray(prev),
                                    [jnp.asarray(b) for b in blocks], ids,
                                    weights=weights)
    _exact(got, want)
    if weights == (0.0, 0.0, 0.0, 0.0):  # every client a no-op, up to
        # the rounding of a mean of k copies of the global block
        np.testing.assert_allclose(got.numpy(), prev, rtol=0,
                                   atol=MEAN_ATOL)


def test_aggregate_basis_matches_reference():
    rng = np.random.default_rng(6)
    bases = [rng.standard_normal((9, 8, 8)).astype(np.float32)
             for _ in range(4)]
    prev = rng.standard_normal((9, 8, 8)).astype(np.float32)
    ws = (0.5, 1.0, 0.125, 1.7)
    for w in (None, ws):
        got = ta.aggregate_basis([_t(b) for b in bases], weights=w,
                                 prev=_t(prev))
        want = ja.aggregate_basis([jnp.asarray(b) for b in bases],
                                  weights=w, prev=jnp.asarray(prev))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=MEAN_ATOL)
    with pytest.raises(ValueError):
        ta.aggregate_basis([_t(b) for b in bases], weights=ws)


# ---------------------------------------------------------------------------
# engine level: collective vs host within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return t_setup(num_clients=8, device="cpu")


def _run(setup, scheme, backend, rounds=3, **kw):
    tm, tx, ty, tt = setup
    cfg = TConfig(num_clients=8, clients_per_round=3, eval_every=1,
                  agg_backend=backend, forward_impl="rank_space", **kw)
    r = t_build(scheme, tm, tx, ty, tt, cfg=cfg, device="cpu")
    r.run(rounds)
    return r


@pytest.mark.parametrize("scheme", SCHEMES)
def test_collective_equals_host_bitwise(scheme, setup):
    host = _run(setup, scheme, "host")
    coll = _run(setup, scheme, "collective")
    assert coll.history == host.history
    lh, lc = tree_leaves(host.params), tree_leaves(coll.params)
    assert len(lh) == len(lc)
    for a, b in zip(lh, lc):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# participation with exclude, and the paper's to-accuracy metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exclude", [frozenset(), frozenset({0, 3, 5}),
                                     frozenset(range(7)),
                                     frozenset(range(8))],
                         ids=["none", "three", "all_but_one", "all"])
def test_uniform_sample_with_exclude_matches_reference(exclude, setup):
    jm, jx, jy, jt = j_setup(num_clients=8)
    cfg = dict(num_clients=8, clients_per_round=3, agg_backend="host")
    jr = j_build("fedavg", jm, jx, jy, jt, cfg=JConfig(**cfg))
    tm, tx, ty, tt = setup
    tr = t_build("fedavg", tm, tx, ty, tt, cfg=TConfig(**cfg), device="cpu")
    for k in (3, 1, 5):
        got = tr.sampler.sample(tr.state, k, exclude)
        want = jr.sampler.sample(jr.state, k, exclude)
        assert got == want
        assert not set(got) & exclude
    assert tr.state.rng.bit_generator.state == \
        jr.state.rng.bit_generator.state


def _hist(accs, step=10.0):
    return [RoundLog(i + 1, step * (i + 1), 1e6 * (i + 1), step, 0.0, 1.0,
                     a) for i, a in enumerate(accs)]


@pytest.mark.parametrize("accs,target", [
    ([], 0.5),
    ([0.1, None, 0.5, 0.7], 0.5),
    ([0.1, None, 0.3], 0.5),
    ([None, None], 0.0),
    ([0.9, 0.95], 0.9),
], ids=["empty", "reached", "unreached", "never_evaluated", "first_round"])
def test_to_accuracy_metrics_match_reference(accs, target):
    hist = _hist(accs)
    for fn in ("time_to_accuracy", "traffic_to_accuracy"):
        got = getattr(tsim, fn)(hist, target)
        assert got == getattr(jsim, fn)(hist, target), fn
    if accs == [0.1, None, 0.5, 0.7]:
        assert tsim.time_to_accuracy(hist, target) == 30.0
        assert tsim.traffic_to_accuracy(hist, target) == 3e6
    assert tsim.time_to_accuracy(None, target) is None


def test_default_config_runs_collective(setup):
    """``FLConfig()``'s own backend, no knob passed."""
    tm, tx, ty, tt = setup
    r = t_build("heroes", tm, tx, ty, tt, device="cpu",
                cfg=dataclasses.replace(TConfig(), num_clients=8,
                                        clients_per_round=3, tau_fixed=2))
    assert TConfig().agg_backend == "collective"
    r.run(1)
    assert all(bool(torch.isfinite(v).all()) for v in tree_leaves(r.params))
