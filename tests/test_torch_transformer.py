"""The port's composed transformer against the JAX package's.

Weights are the reference's own (``init_factorized`` / ``init_dense``),
carried across with ``repro_torch.convert.from_jax_params``; inputs are
drawn with numpy.  Held to the reference:

* the training forward's logits and the loss gradients at widths 1-3
  under ``materialize`` and ``rank_space`` (atol 2e-4, rtol 2e-3, as
  ``tests/test_transformer_fl.py``'s gradient-parity matrix);
* the ``embed`` layer on both paths;
* the ``synthetic_text`` arrays, byte for byte;
* heroes and fedavg 3-round histories on ``build_text_setup(num_clients=8,
  model_name="transformer")``: widths, τ, block ids, traffic and makespan
  equal, client estimates within 1e-3;
* greedy decode with the ``kernel`` and ``inline`` backends: tokens equal
  to the reference's ``greedy_decode(backend="pallas", interpret=True)``,
  last logits within 1e-4; ``serving_weights`` on the dense path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticTextTask as JText
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.data.synthetic import load_synthetic_text as j_load_text
from repro.fl import FLConfig as JConfig
from repro.fl import build_runner as j_build
from repro.fl import build_text_setup as j_text_setup
from repro.fl import client as jclient
from repro.fl import greedy_decode as j_decode
from repro.fl import make_transformer as j_make
from repro.fl import serving_weights as j_serving
from repro.fl.models import _apply_embed as j_apply_embed
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves
from repro_torch.data.synthetic import SyntheticTextTask as TText
from repro_torch.data.synthetic import lm_batches as t_lm_batches
from repro_torch.data.synthetic import load_synthetic_text as t_load_text
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_runner as t_build
from repro_torch.fl import build_text_setup as t_text_setup
from repro_torch.fl import client as tclient
from repro_torch.fl import greedy_decode as t_decode
from repro_torch.fl import make_transformer as t_make
from repro_torch.fl import serving_weights as t_serving
from repro_torch.fl.models import _apply_embed as t_apply_embed
from repro_torch.fl.transformer import arch_of
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ATOL, RTOL = 2e-4, 2e-3
EST_TOL = 1e-3


def _reduced(width, seed=0):
    """Reference factors reduced to the width's leading blocks, on both
    sides."""
    jm, tm = j_make(), t_make()
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(seed)))
    sq = next(s for s in jm.specs.values() if s.mode == "square")
    hidden, anch = np.arange(sq.blocks_for_width(width)), np.arange(width)
    return (jm, tm, jm.reduce(params, width, hidden, anch),
            tm.reduce(from_jax_params(params, "cpu"), width, hidden, anch))


def _text_batch(seed, n=8, t=32, vocab=64):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (n, t)).astype(np.int32)
    lab = rng.integers(0, vocab, (n, t)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(lab).long()})


def _leaves(tree):
    """Leaves in sorted-key order, as numpy (the two packages' trees
    share their keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree.detach() if hasattr(tree, "detach") else tree)]


@pytest.mark.parametrize("impl", ["materialize", "rank_space"])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_forward_logits_and_grads_match(impl, width):
    jm, tm, jred, tred = _reduced(width, seed=width)
    jb, tb = _text_batch(width)
    jw = jm.prepare_weights(jred, width, jb, impl)
    tw = tm.prepare_weights(tred, width, tb, impl)
    assert {k: isinstance(v, dict) for k, v in jw.items()} == \
        {k: isinstance(v, dict) for k, v in tw.items()}
    with torch.no_grad():
        logits = tm.forward(tw, width, tb)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.forward(jw, width, jb)),
                               atol=ATOL, rtol=RTOL)
    _, jgrad, _ = jclient._jitted_fns(jm, width, True, impl)
    tgrad = tclient.ClientFns(tm, width, True, impl).grad(tred, tb)
    for a, b in zip(_leaves(jgrad(jred, jb)), _leaves(tgrad)):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("factorized", [True, False])
@pytest.mark.parametrize("width", [1, 3])
def test_embed_layer_matches(factorized, width):
    jm, tm, jred, tred = _reduced(width, seed=7)
    spec = jm.specs["embed"]
    tok = np.random.default_rng(width).integers(0, 64, (3, 5)).astype(
        np.int32)
    if factorized:
        jentry, tentry = jred["embed"], tred["embed"]
    else:
        jentry = jm.compose_all(jred, width)["embed"]
        tentry = tm.compose_all(tred, width)["embed"]
    got = t_apply_embed(tentry, torch.from_numpy(tok), width, spec)
    assert got.shape == (3, 5, width * spec.base_out)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_apply_embed(jentry, jnp.asarray(tok),
                                              width, spec)),
        atol=1e-6, rtol=1e-5)


def test_synthetic_text_is_byte_equal():
    j, t = JText(seed=3, num_train=50, num_test=20), TText(
        seed=3, num_train=50, num_test=20)
    for a, b in ((j.table, t.table), (j.train, t.train), (j.test, t.test)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jd, td = j_load_text(seed=0), t_load_text(seed=0)
    assert jd.metadata == td.metadata
    for split in ("train", "test"):
        for a, b in zip(jd.splits[split], td.splits[split]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(jd.partition_labels, td.partition_labels)
    for a, b in zip(j_lm_batches(j.train, 6, np.random.default_rng(4)),
                    t_lm_batches(t.train, 6, np.random.default_rng(4))):
        assert np.array_equal(a, b)


def _record(runner):
    """Log each round's assignments and client results (same wiring on
    both engines)."""
    log = []
    assign, train_all = runner.assignment.assign, runner.trainer.train_all

    def ids(a, key):
        return None if a.get(key) is None else [int(i) for i in a[key]]

    def assign_rec(state, clients):
        state, assigns = assign(state, clients)
        log.append({"assign": {
            int(n): (a["width"], a["tau"], ids(a, "hidden_ids"),
                     ids(a, "anchored_ids")) for n, a in assigns.items()}})
        return state, assigns

    def train_rec(state, assigns):
        results = train_all(state, assigns)
        log[-1]["est"] = {int(n): dict(r.estimates, loss_before=r.loss_before,
                                       loss_after=r.loss_after)
                          for n, r in results.items()}
        return results

    runner.assignment.assign = assign_rec
    runner.trainer.train_all = train_rec
    return log


@pytest.mark.parametrize("scheme,impl", [("heroes", "rank_space"),
                                         ("fedavg", "materialize")])
def test_run_scheme_matches_reference(scheme, impl):
    kw = dict(num_clients=8, clients_per_round=3, batch_size=8,
              agg_backend="host", forward_impl=impl, eval_every=1)
    jm, jx, jy, jt = j_text_setup(num_clients=8, model_name="transformer")
    jr = j_build(scheme, jm, jx, jy, jt, cfg=JConfig(**kw))
    jlog = _record(jr)
    jh = jr.run(3)

    tm, tx, ty, tt = t_text_setup(num_clients=8, model_name="transformer",
                                  device="cpu")
    np.testing.assert_array_equal(np.asarray(jt["tokens"]),
                                  tt["tokens"].numpy())
    tr = t_build(scheme, tm, tx, ty, tt, cfg=TConfig(**kw), device="cpu")
    init = (jm.init_factorized if scheme == "heroes" else jm.init_dense)(
        jax.random.PRNGKey(0))
    tr.state = dataclasses.replace(
        tr.state, params=from_jax_params(jax.device_get(init), "cpu"))
    tlog = _record(tr)
    th = tr.run(3)

    n_test = int(tt["labels"].shape[0])
    assert len(th) == len(jh) == 3
    for a, b in zip(jh, th):
        assert (a.round, a.wall_time, a.traffic_bytes, a.makespan,
                a.avg_wait, a.mean_tau, a.up_bytes, a.down_bytes) == \
            (b.round, b.wall_time, b.traffic_bytes, b.makespan,
             b.avg_wait, b.mean_tau, b.up_bytes, b.down_bytes)
        assert abs(a.accuracy - b.accuracy) <= 2.0 / n_test
    for ra, rb in zip(jlog, tlog):
        assert ra["assign"] == rb["assign"]
        assert ra["est"].keys() == rb["est"].keys()
        for n, ea in ra["est"].items():
            for k, va in ea.items():
                vb = rb["est"][n][k]
                assert abs(va - vb) <= EST_TOL * max(abs(va), 1e-12), (n, k)


@pytest.mark.parametrize("width", [1, 2])
def test_greedy_decode_matches_reference(width):
    jm, tm = j_make(), t_make()
    params = jax.device_get(jm.init_factorized(jax.random.PRNGKey(0)))
    jw = j_serving(jm, params, width)
    tw = t_serving(tm, from_jax_params(params, "cpu"), width)
    for name in jw:
        np.testing.assert_allclose(tw[name].numpy(), np.asarray(jw[name]),
                                   atol=1e-6, rtol=1e-5)
    prompt = np.random.default_rng(1).integers(0, 64, (2, 6)).astype(
        np.int32)
    steps = 5
    jt, jl = j_decode(jm, jw, width, prompt, steps, backend="pallas",
                      interpret=True)
    for backend in ("kernel", "inline"):
        tt, tl = t_decode(tm, tw, width, prompt, steps, backend=backend)
        assert tt.shape == (2, steps) and tt.dtype == np.int32
        assert np.array_equal(tt, jt), backend
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    # greedy consistency: the full-sequence training forward predicts
    # exactly the generated continuation
    seq = torch.from_numpy(np.concatenate([prompt, tt], axis=1))
    with torch.no_grad():
        full = tm.forward(tw, width, {"tokens": seq})
    pred = full.argmax(-1).numpy()[:, prompt.shape[1] - 1:-1]
    assert np.array_equal(pred, tt)


def test_serving_weights_dense_path():
    jm, tm = j_make(), t_make()
    dense = jax.device_get(jm.init_dense(jax.random.PRNGKey(2)))
    jw = j_serving(jm, dense, 2, factorized=False)
    tw = t_serving(tm, from_jax_params(dense, "cpu"), 2, factorized=False)
    arch = arch_of(tm)
    assert tw["embed"].shape == (1, arch.vocab, 2 * arch.d_base)
    for name in jw:
        np.testing.assert_array_equal(tw[name].numpy(), np.asarray(jw[name]))
    prompt = np.zeros((1, 2), np.int32)
    jt, _ = j_decode(jm, jw, 2, prompt, 3, backend="xla")
    tt, _ = t_decode(tm, tw, 2, prompt, 3)
    assert np.array_equal(tt, jt)


def test_transformer_defs_match_reference():
    jm, tm = j_make(), t_make()
    assert list(jm.specs) == list(tm.specs)
    for name in jm.specs:
        assert dataclasses.asdict(jm.specs[name]) == \
            dataclasses.asdict(tm.specs[name])
        jh, th = jm.hints[name], tm.hints[name]
        assert (jh.apps_per_sample, jh.rank_capable, jh.dense_apply_free,
                jh.basis_gather) == (th.apps_per_sample, th.rank_capable,
                                     th.dense_apply_free, th.basis_gather)
    for p in (1, 2, 3):
        assert jm.flops_per_sample(p) == tm.flops_per_sample(p)
    assert tm.input_key == "tokens" and tm.num_classes == 64
    assert t_make() is tm  # memoized: one instance per config


def test_decode_rejects_bad_arguments():
    tm = t_make()
    w = t_serving(tm, tm.init_factorized(0, "cpu"), 1)
    with pytest.raises(ValueError, match="backend"):
        t_decode(tm, w, 1, np.zeros((1, 2), np.int32), 2, backend="pallas")
    with pytest.raises(ValueError, match="max_len"):
        t_decode(tm, w, 1, np.zeros((1, 2), np.int32), 4, max_len=3)
    with pytest.raises(ValueError, match="not built by make_transformer"):
        from repro_torch.fl.models import make_cnn

        arch_of(make_cnn())
    assert all(t.device.type == "cpu" for t in tree_leaves(w))
