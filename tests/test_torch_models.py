"""The port's CNN against the JAX package's, from the same weights.

The reference's own ``init_factorized`` / ``init_dense`` weights are
carried across with ``repro_torch.convert.from_jax_params``; logits and
gradients of the cross-entropy loss must agree within 1e-4 (f32, three
convs deep) under every ``forward_impl``, with the ``auto`` calibration
pinned on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.calibration import RankPathCalibration as JCal
from repro.fl import client as jclient
from repro.fl.models import make_cnn as j_make_cnn
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.core.calibration import RankPathCalibration as TCal
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import client as tclient
from repro_torch.fl.models import get_model, make_cnn as t_make_cnn

TOL = 1e-4
PIN = dict(conv_rank_overhead=1.0, fused_compose_gain=0.5)


def _setup(width, seed=0, batch=16):
    jm, tm = j_make_cnn(), t_make_cnn()
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(seed)))
    hidden = np.arange(width * width)
    anch = np.arange(width)
    jred = jm.reduce(params, width, hidden, anch)
    tred = tm.reduce(from_jax_params(params, "cpu"), width, hidden, anch)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, batch)
    jb = {"x": jnp.asarray(x), "labels": jnp.asarray(y.astype(np.int32))}
    tb = {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    return jm, tm, jred, tred, jb, tb


def _flat_grads(tree):
    return [np.asarray(a) for _, a in sorted(
        ((k1 + "/" + k2, v2) for k1, v1 in tree.items()
         for k2, v2 in v1.items()))]


@pytest.mark.parametrize("impl", ["materialize", "rank_space", "auto"])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_cnn_logits_and_grads_match(impl, width):
    jm, tm, jred, tred, jb, tb = _setup(width, seed=width)
    jcal = JCal(**PIN) if impl == "auto" else None
    tcal = TCal(**PIN) if impl == "auto" else None
    jw = jm.prepare_weights(jred, width, jb, impl, jcal)
    tw = tm.prepare_weights(tred, width, tb, impl, tcal)
    assert {k: isinstance(v, dict) for k, v in jw.items()} == \
        {k: isinstance(v, dict) for k, v in tw.items()}

    def jlogits(p):
        return jm.forward(jm.prepare_weights(p, width, jb, impl, jcal),
                          width, jb)

    with torch.no_grad():
        got = tm.forward(tw, width, tb).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jlogits)(jred)),
                               atol=TOL, rtol=TOL)

    def jloss(p):
        return jclient._ce(jlogits(p), jb["labels"])

    jg = jax.jit(jax.grad(jloss))(jred)
    fns = tclient.ClientFns(tm, width, True, impl, tcal)
    tg = to_numpy(fns.grad(tred, tb))
    for a, b in zip(_flat_grads(tg), _flat_grads(jax.device_get(jg))):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("gain", [0.5, 2.0])
@pytest.mark.parametrize("overhead", [0.5, 1.0, 8.0])
def test_layer_impls_equal(gain, overhead):
    jm, tm = j_make_cnn(), t_make_cnn()
    for width in (1, 2, 3):
        for bs in (1, 16, 500):
            shape = (bs, 8, 8, 3)
            for impl in ("materialize", "rank_space", "auto"):
                assert jm.layer_impls(width, bs, impl, shape,
                                      JCal(overhead, gain)) == \
                    tm.layer_impls(width, bs, impl, shape,
                                   TCal(overhead, gain))
                assert jm.apply_flops_per_sample(
                    width, bs, impl, shape, JCal(overhead, gain)) == \
                    tm.apply_flops_per_sample(width, bs, impl, shape,
                                              TCal(overhead, gain))


def test_pinned_auto_takes_all_four_primitives_at_full_width():
    """At p=3, batch 16 with the smoke's pins, ``auto`` runs the convs in
    rank space and the head through the fused compose+apply kernel."""
    impls = t_make_cnn().layer_impls(3, 16, "auto", (16, 8, 8, 3),
                                     TCal(**PIN))
    assert impls == {"conv1": "rank_space", "conv2": "rank_space",
                     "conv3": "rank_space", "fc": "fused_compose"}


def test_dense_forward_matches():
    """FedAvg's dense parameterisation, from the reference's init_dense."""
    jm, tm = j_make_cnn(), t_make_cnn()
    params = jax.device_get(jm.init_dense(jax.random.PRNGKey(3)))
    x = np.random.default_rng(3).standard_normal((8, 8, 8, 3)).astype(
        np.float32)
    want = jm.forward(params, 3, {"x": jnp.asarray(x)})
    with torch.no_grad():
        got = tm.forward(from_jax_params(params, "cpu"), 3,
                         {"x": torch.from_numpy(x)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for w in (1, 2, 3):
        assert jm.flops_per_sample(w) == tm.flops_per_sample(w)
        assert jm.factorized_bytes(w) == tm.factorized_bytes(w)
        assert jm.dense_bytes(w) == tm.dense_bytes(w)


def test_convert_round_trip_and_init_shapes():
    jm, tm = j_make_cnn(), t_make_cnn()
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(0)))
    back = to_numpy(from_jax_params(params, "cpu"))
    for name in params:
        for key in ("basis", "coeff"):
            np.testing.assert_array_equal(back[name][key], params[name][key])
    mine = tm.init_factorized(0, "cpu")
    assert {n: {k: tuple(v.shape) for k, v in d.items()}
            for n, d in mine.items()} == \
        {n: {k: tuple(v.shape) for k, v in d.items()}
         for n, d in params.items()}
    assert all(t.dtype == torch.float32 for t in tree_leaves(mine))


def test_unported_models_raise():
    """No model of the reference is left unported: ``resnet`` and ``rnn``,
    which raised until they were, resolve with the reference's
    modalities, as the composed transformer does; an unknown name still
    raises."""
    from repro.fl.models import get_model as j_get_model

    for name in ("cnn", "resnet", "rnn", "transformer"):
        assert get_model(name).modality == j_get_model(name).modality
    assert get_model("resnet").modality == "image"
    assert get_model("rnn").modality == "text"
    with pytest.raises(ValueError, match="unknown model"):
        get_model("lstm")


def test_calibration_measures_on_the_cpu_and_honours_pins():
    """Unpinned ``auto`` measures the two knobs on the port's primitives
    (clipped like the reference's); pins bypass the measurement, and
    non-auto configs never consult it."""
    from repro_torch.core import calibration as cal
    from repro_torch.fl.types import FLConfig

    got = cal.get_calibration("cpu")
    assert got.measured and got.platform == "cpu"
    assert 0.25 <= got.conv_rank_overhead <= 32.0
    assert 0.25 <= got.fused_compose_gain <= 4.0
    assert cal.get_calibration("cpu") is got  # cached per device
    pinned = cal.from_config(FLConfig(**PIN), "cpu")
    assert (pinned.conv_rank_overhead, pinned.fused_compose_gain,
            pinned.measured) == (1.0, 0.5, False)
    half = cal.from_config(FLConfig(fused_compose_gain=0.5), "cpu")
    assert (half.conv_rank_overhead, half.fused_compose_gain) == \
        (got.conv_rank_overhead, 0.5)
    assert cal.for_dispatch(FLConfig(forward_impl="rank_space"), "cpu") is None
    impls = t_make_cnn().layer_impls(3, 16, "auto", (16, 8, 8, 3),
                                     device="cpu")
    assert set(impls.values()) <= {"rank_space", "materialize",
                                   "fused_compose"}
