"""repro_torch.core.composition against live calls into repro.core.composition.

Integer results (block selection, FLOPs counts, the dispatch decision)
must be equal; float results agree within 1e-5 (f32, a handful of terms
per sum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import composition as jc
from repro_torch.core import composition as tc

TOL = 1e-5
MODES = ("square", "grow_out", "grow_in")


def _specs(mode, ksq=9):
    return (jc.CompositionSpec(3, 8, 6, 5, ksq=ksq, mode=mode),
            tc.CompositionSpec(3, 8, 6, 5, ksq=ksq, mode=mode))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mode", MODES)
def test_spec_shapes_and_counts_equal(mode):
    js, ts = _specs(mode)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert js.num_blocks == ts.num_blocks
    assert (js.basis_shape(), js.coefficient_shape()) == \
        (ts.basis_shape(), ts.coefficient_shape())
    for p in (1, 2, 3):
        assert js.blocks_for_width(p) == ts.blocks_for_width(p)
        assert js.weight_shape(p) == ts.weight_shape(p)
        assert js.params_factorized(p) == ts.params_factorized(p)
        assert js.params_materialized(p) == ts.params_materialized(p)
    with pytest.raises(ValueError):
        ts.blocks_for_width(4)


@pytest.mark.parametrize("seed", range(4))
def test_select_blocks_equal(seed):
    rng = np.random.default_rng(seed)
    js, ts = _specs("square")
    counters = rng.integers(0, 4, js.num_blocks)  # small range: many ties
    for p in (1, 2, 3):
        np.testing.assert_array_equal(jc.select_blocks(counters, p, js),
                                      tc.select_blocks(counters, p, ts))


def test_gather_blocks_equal_and_raise_out_of_range():
    u = np.random.default_rng(0).standard_normal((9, 8, 5)).astype(np.float32)
    ids = np.array([0, 4, 8])
    np.testing.assert_array_equal(
        np.asarray(jc.gather_blocks(jnp.asarray(u), ids)),
        tc.gather_blocks(torch.from_numpy(u), ids).numpy())
    for bad in ([0, 9], [-1, 2]):
        with pytest.raises(ValueError, match="out of range"):
            jc.gather_blocks(jnp.asarray(u), np.array(bad))
        with pytest.raises(ValueError, match="out of range"):
            tc.gather_blocks(torch.from_numpy(u), np.array(bad))


def _factors(js, p, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    v = (scale * rng.standard_normal(js.basis_shape())).astype(np.float32)
    u = (scale * rng.standard_normal(
        (js.blocks_for_width(p),) + js.coefficient_shape()[1:])
         ).astype(np.float32)
    return v, u


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_compose_matches(mode, p, backend):
    js, ts = _specs(mode)
    v, u = _factors(js, p, seed=p)
    want = jc.compose(jnp.asarray(v), jnp.asarray(u), p, js, backend="einsum")
    got = tc.compose(torch.from_numpy(v), torch.from_numpy(u), p, ts,
                     backend=backend)
    assert tuple(got.shape) == ts.weight_shape(p)
    _close(got.numpy(), want)


def test_compose_rejects_wrong_block_count_and_backend():
    _, ts = _specs("square")
    v = torch.zeros(ts.basis_shape())
    with pytest.raises(ValueError, match="blocks"):
        tc.compose(v, torch.zeros((3, 8, 5)), 2, ts)
    with pytest.raises(ValueError, match="backend"):
        tc.compose(v, torch.zeros((4, 8, 5)), 2, ts, backend="pallas")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("fused", [True, False])
def test_apply_factors_conv_matches(mode, p, fused):
    js, ts = _specs(mode)
    v, u = _factors(js, p, seed=10 + p)
    g = 1 if mode == "grow_out" else p
    x = np.random.default_rng(p).standard_normal(
        (2, 8, 8, g * js.base_in)).astype(np.float32)
    want = jc.apply_factors(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u),
                            p, js, "conv", stride=2, fused=fused)
    got = tc.apply_factors(torch.from_numpy(x), torch.from_numpy(v),
                           torch.from_numpy(u), p, ts, "conv", stride=2,
                           fused=fused)
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3])
def test_apply_factors_dense_matches(mode, p):
    js, ts = _specs(mode, ksq=1)
    v, u = _factors(js, p, seed=20 + p)
    x = np.random.default_rng(p).standard_normal(
        (5, js.weight_shape(p)[1])).astype(np.float32)
    want = jc.apply_factors(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u),
                            p, js, "dense")
    got = tc.apply_factors(torch.from_numpy(x), torch.from_numpy(v),
                           torch.from_numpy(u), p, ts, "dense")
    _close(got.numpy(), want)
    _, conv_spec = _specs(mode, ksq=9)
    with pytest.raises(ValueError, match="ksq"):
        tc.apply_factors(torch.from_numpy(x), torch.zeros(9, 6, 8),
                         torch.from_numpy(u), p, conv_spec, "dense")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ksq", [1, 9])
def test_flops_and_dispatch_equal(mode, ksq):
    js, ts = _specs(mode, ksq=ksq)
    for p in (1, 2, 3):
        assert jc.compose_flops(p, js) == tc.compose_flops(p, ts)
        for apps in (1, 16, 256, 4096):
            for gather in (False, True):
                assert jc.apply_flops(p, js, applications=apps,
                                      basis_is_gather=gather) == \
                    tc.apply_flops(p, ts, applications=apps,
                                   basis_is_gather=gather)
            assert jc.dense_apply_flops(p, js, applications=apps) == \
                tc.dense_apply_flops(p, ts, applications=apps)
            for ovh in (0.5, 1.0, 3.0):
                for free in (False, True):
                    assert jc.rank_space_wins(
                        p, js, applications=apps, overhead=ovh,
                        dense_apply_free=free) == tc.rank_space_wins(
                        p, ts, applications=apps, overhead=ovh,
                        dense_apply_free=free)


def test_init_factors_scale():
    """Same fan-in variance rule as the reference (the draws differ: a
    torch generator vs a jax key)."""
    _, ts = _specs("square")
    v, u = tc.init_factors(torch.Generator().manual_seed(0), ts)
    assert tuple(v.shape) == ts.basis_shape()
    assert tuple(u.shape) == ts.coefficient_shape()
    std = (1.0 / (ts.ksq * ts.base_in) / ts.rank) ** 0.25
    for t in (v, u):
        assert abs(float(t.std()) / std - 1.0) < 0.15


# decompose solves a least-squares system of a handful of terms per sum
# in f32 on both sides (LAPACK's gels here, an SVD-based solve in jax)
DECOMPOSE_TOL = 1e-4


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("ksq", [9, 1])
def test_decompose_matches_and_inverts_compose(p, ksq):
    js = jc.CompositionSpec(3, 4, 6, 5, ksq=ksq)
    ts = tc.CompositionSpec(3, 4, 6, 5, ksq=ksq)
    rng = np.random.default_rng(10 * p + ksq)
    v = rng.standard_normal(ts.basis_shape()).astype(np.float32)
    w = rng.standard_normal(ts.weight_shape(p)).astype(np.float32)
    want = np.asarray(jc.decompose(jnp.asarray(w), jnp.asarray(v), p, js))
    got = tc.decompose(torch.from_numpy(w), torch.from_numpy(v), p, ts)
    assert tuple(got.shape) == want.shape == (p * p, 4, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=DECOMPOSE_TOL,
                               rtol=DECOMPOSE_TOL)
    # a weight in the basis's span comes back whole
    u = torch.from_numpy(rng.standard_normal((p * p, 4, 5)).astype(
        np.float32))
    vt = torch.from_numpy(v)
    w_span = tc.compose(vt, u, p, ts)
    back = tc.decompose(w_span, vt, p, ts)
    np.testing.assert_allclose(back.numpy(), u.numpy(), atol=DECOMPOSE_TOL,
                               rtol=DECOMPOSE_TOL)
    np.testing.assert_allclose(tc.compose(vt, back, p, ts).numpy(),
                               w_span.numpy(), atol=DECOMPOSE_TOL,
                               rtol=DECOMPOSE_TOL)


def test_decompose_refuses_what_it_cannot_solve():
    ts = tc.CompositionSpec(3, 8, 6, 5, ksq=1)  # ksq*I = 6 < rank 8
    with pytest.raises(ValueError, match="full column rank"):
        tc.decompose(torch.zeros(1, 12, 10), torch.zeros(1, 6, 8), 2, ts)
    ok = tc.CompositionSpec(3, 4, 6, 5, ksq=9)
    with pytest.raises(ValueError, match="inconsistent"):
        tc.decompose(torch.zeros(9, 12, 5), torch.zeros(9, 6, 4), 2, ok)


def _plan_specs(mod):
    return {"conv": mod.CompositionSpec(3, 8, 6, 5, ksq=9),
            "stem": mod.CompositionSpec(3, 8, 3, 5, ksq=9, mode="grow_out"),
            "head": mod.CompositionSpec(3, 8, 5, 10, mode="grow_in")}


def test_composition_plan_matches():
    jplan = jc.CompositionPlan(_plan_specs(jc), 3)
    tplan = tc.CompositionPlan(_plan_specs(tc), 3)
    assert tplan.num_blocks == jplan.num_blocks == 9
    assert tc.LayerPlan("conv", tplan.layers["conv"]).spec == \
        tplan.layers["conv"]
    rng = np.random.default_rng(0)
    params = {n: {"basis": rng.standard_normal(s.basis_shape()).astype(
                      np.float32),
                  "coeff": rng.standard_normal(
                      s.coefficient_shape()).astype(np.float32)}
              for n, s in tplan.layers.items()}
    tparams = {n: {k: torch.from_numpy(a) for k, a in d.items()}
               for n, d in params.items()}
    # the shared P^2-counter ids are valid only for square layers: the
    # anchored ones (3 blocks) refuse id 3 and above, on both sides
    with pytest.raises(ValueError, match="anchored layers"):
        jplan.reduce(params, [0, 4])
    with pytest.raises(ValueError, match="anchored layers"):
        tplan.reduce(tparams, [0, 4])
    for p in (1, 2, 3):
        assert tplan.traffic_bytes(p) == jplan.traffic_bytes(p)
        assert tplan.materialized_bytes(p) == jplan.materialized_bytes(p)
        assert tplan.traffic_bytes(p, 2) == jplan.traffic_bytes(p, 2)
    # one id set serves every layer, so a mixed plan composes at p = 1, a
    # square one at p^2 ids and an anchored one at p ids
    cases = [(list(tplan.layers), [2], 1),
             (["conv"], [1, 4, 5, 8], 2), (["conv"], list(range(9)), 3),
             (["stem", "head"], [0, 2], 2)]
    for names, ids, p in cases:
        jsub = jc.CompositionPlan({n: jplan.layers[n] for n in names}, 3)
        tsub = tc.CompositionPlan({n: tplan.layers[n] for n in names}, 3)
        jred, tred = jsub.reduce(params, ids), tsub.reduce(tparams, ids)
        jw, tw = jsub.compose_all(jred, p), tsub.compose_all(tred, p)
        for n in names:
            np.testing.assert_array_equal(tred[n]["coeff"].numpy(),
                                          np.asarray(jred[n]["coeff"]))
            _close(tw[n].numpy(), jw[n])
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="max_width"):
            mod.CompositionPlan(_plan_specs(mod), 2)


def test_composition_plan_init_from_a_torch_generator():
    """Factors drawn in sorted layer order from the port's generator (the
    draws differ from the reference's jax key by construction), with the
    reference's shapes and dtype."""
    jplan = jc.CompositionPlan(_plan_specs(jc), 3)
    tplan = tc.CompositionPlan(_plan_specs(tc), 3)
    want = jplan.init(jax.random.PRNGKey(0))
    got = tplan.init(torch.Generator().manual_seed(0), "cpu")
    assert list(got) == sorted(tplan.layers) == list(want)
    for n in want:
        for k in ("basis", "coeff"):
            assert tuple(got[n][k].shape) == want[n][k].shape
            assert got[n][k].dtype == torch.float32
    # one generator drawn layer after layer, in sorted order
    gen = torch.Generator().manual_seed(0)
    for n in sorted(tplan.layers):
        v, u = tc.init_factors(gen, tplan.layers[n])
        assert torch.equal(v, got[n]["basis"])
        assert torch.equal(u, got[n]["coeff"])
    f64 = tplan.init(torch.Generator().manual_seed(1), "cpu", torch.float64)
    assert f64["conv"]["basis"].dtype == torch.float64
