"""repro_torch.core.composition against live calls into repro.core.composition.

Integer results (block selection, FLOPs counts, the dispatch decision)
must be equal; float results agree within 1e-5 (f32, a handful of terms
per sum).
"""

import dataclasses

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
