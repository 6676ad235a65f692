"""The port's checkpoint format and ServerState codec.

``repro_torch.checkpoint.npz_ckpt`` takes the JAX package's
``tests/test_checkpoint.py`` cases on its own format (npz, no msgpack):
dtype-preserving round trips (bf16 from a ``torch.bfloat16`` tensor
included), atomic step-directory writes, keep-N pruning and
``restore_latest``'s step choice.  The codec
(``repro_torch.fl.engine.state``) round-trips every scheme's state, and
after two heroes rounds from the reference's weights its meta document
equals the reference's ``state_to_payload`` meta.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro.fl.engine import state as j_state
from repro_torch.checkpoint.npz_ckpt import (load_checkpoint, restore_latest,
                                             save_checkpoint)
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl.engine import state as t_state
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "heroes")


def test_roundtrip_preserves_dtypes_and_values(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(5,)),
        "i64": rng.integers(-7, 7, size=(2, 3)),
        "u8": rng.integers(0, 255, size=(4,)).astype(np.uint8),
        "nested": {"list": [np.float32(1.5), np.arange(3)],
                   "bool": np.array([True, False])},
        "bf16": torch.tensor(rng.normal(size=(6,)), dtype=torch.bfloat16),
        "tensor": torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32),
    }
    p = save_checkpoint(tmp_path, 3, state)
    assert not (p / "state.msgpack").exists() and (p / "state.npz").exists()
    got = load_checkpoint(p)
    for k in ("f32", "f64", "i64", "u8"):
        assert got[k].dtype == state[k].dtype
        np.testing.assert_array_equal(got[k], state[k])
    np.testing.assert_array_equal(got["nested"]["bool"],
                                  state["nested"]["bool"])
    # lists flatten to string-indexed dict nodes; scalars stay 0-d
    assert got["nested"]["list"]["0"].shape == ()
    np.testing.assert_array_equal(got["nested"]["list"]["1"],
                                  state["nested"]["list"][1])
    # a torch leaf comes back as the numpy array of its values
    assert got["tensor"].dtype == np.float32
    np.testing.assert_array_equal(got["tensor"], state["tensor"].numpy())
    # bf16 has no numpy dtype: stored as its bits, loaded as bf16 again
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.int16),
                       state["bf16"].view(torch.int16))
    manifest = json.loads((p / "manifest.json").read_text())
    assert manifest["dtypes"] == {"bf16": "bfloat16"}
    with np.load(p / "state.npz", allow_pickle=False) as z:
        assert sorted(z.files) == sorted(
            ["f32", "f64", "i64", "u8", "nested/list/0", "nested/list/1",
             "nested/bool", "bf16", "tensor"])


def test_atomic_write_no_partial_step_on_interrupt(tmp_path, monkeypatch):
    state = {"w": np.arange(8, dtype=np.float32)}
    save_checkpoint(tmp_path, 1, state)

    real_write = pathlib.Path.write_bytes

    def boom(self, data):
        raise OSError("disk pulled mid-write")

    monkeypatch.setattr(pathlib.Path, "write_bytes", boom)
    with pytest.raises(OSError, match="disk pulled"):
        save_checkpoint(tmp_path, 2, state)
    monkeypatch.setattr(pathlib.Path, "write_bytes", real_write)

    # the interrupted step left no directory — partial or otherwise
    assert not (tmp_path / "step_00000002").exists()
    assert not list(tmp_path.glob("step_*.tmp.*"))
    step, got = restore_latest(tmp_path)
    assert step == 1
    np.testing.assert_array_equal(got["w"], state["w"])
    save_checkpoint(tmp_path, 2, {"w": state["w"] + 1})
    step, got = restore_latest(tmp_path)
    assert step == 2
    np.testing.assert_array_equal(got["w"], state["w"] + 1)


def test_restore_latest_picks_highest_step(tmp_path):
    for step in (2, 10, 9):
        save_checkpoint(tmp_path, step, {"s": np.array([step])}, keep=100)
    step, got = restore_latest(tmp_path)
    assert step == 10
    np.testing.assert_array_equal(got["s"], [10])
    # stray non-step entries are never candidates
    (tmp_path / "step_garbage").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert restore_latest(tmp_path)[0] == 10


def test_restore_latest_empty_and_missing(tmp_path):
    assert restore_latest(tmp_path) is None
    assert restore_latest(tmp_path / "nope") is None


def test_keep_prunes_oldest(tmp_path):
    for step in range(1, 6):
        save_checkpoint(tmp_path, step, {"s": np.array([step])}, keep=2)
    names = sorted(p.name for p in tmp_path.glob("step_*"))
    assert names == ["step_00000004", "step_00000005"]


def _cfg(**kw):
    return TConfig(**{"num_clients": 8, "clients_per_round": 3,
                      "tau_fixed": 2, "tau_max": 6, "eval_every": 1,
                      "forward_impl": "materialize", **kw})


@pytest.mark.parametrize("mode", ["sync", "semi_async"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_codec_roundtrip_every_scheme(scheme, mode, tmp_path):
    """state -> payload -> disk -> state gives the same state: params
    (flanc's integer width keys included), counters, rng, history and the
    in-flight records with their on-device results."""
    tm, tx, ty, tt = t_setup(num_clients=8, device="cpu")
    kw = dict(round_mode=mode, async_k=1) if mode == "semi_async" else {}
    r = t_build(scheme, tm, tx, ty, tt, cfg=_cfg(**kw), device="cpu")
    r.run(2)
    st = r.state
    if mode == "semi_async":
        assert st.in_flight
    save_checkpoint(tmp_path, st.round, t_state.state_to_payload(st))
    _, payload = restore_latest(tmp_path)
    fresh = t_build(scheme, tm, tx, ty, tt, cfg=_cfg(**kw), device="cpu")
    got = t_state.payload_to_state(payload, fresh.state.params, "cpu")

    def same_tree(a, b):
        assert isinstance(a, dict) == isinstance(b, dict)
        if isinstance(a, dict):
            assert list(a) == list(b)  # key types and order
            for k in a:
                same_tree(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same_tree(st.params, got.params)
    if scheme == "flanc":
        assert sorted(got.params["coeffs"]) == [1, 2, 3]
    assert got.history == st.history
    assert (got.round, got.wall, got.traffic, got.traffic_up,
            got.traffic_down) == (st.round, st.wall, st.traffic,
                                  st.traffic_up, st.traffic_down)
    assert got.bound_state == st.bound_state
    assert got.participation == st.participation
    assert got.rng.bit_generator.state == st.rng.bit_generator.state
    assert (got.sched is None) == (st.sched is None)
    if st.sched is not None:
        np.testing.assert_array_equal(got.sched.counters, st.sched.counters)
        np.testing.assert_array_equal(got.sched.anchored, st.sched.anchored)
    assert len(got.in_flight) == len(st.in_flight)
    for a, b in zip(st.in_flight, got.in_flight):
        assert (a.client, a.finish, a.dispatched) == (b.client, b.finish,
                                                      b.dispatched)
        assert a.assign.keys() == b.assign.keys()
        for k, v in a.assign.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(
                b.assign[k]))
        same_tree(a.result.params, b.result.params)
        assert (a.result.estimates, a.result.loss_before,
                a.result.loss_after) == (b.result.estimates,
                                         b.result.loss_before,
                                         b.result.loss_after)


def test_meta_matches_reference_after_two_heroes_rounds():
    """The port's meta document against the JAX package's after the same
    two heroes rounds from the same weights: rng state and participation
    exactly, the history as the engine tests hold it."""
    kw = dict(num_clients=8, clients_per_round=3, agg_backend="host",
              forward_impl="rank_space", eval_every=1)
    jm, jx, jy, jt = j_setup(num_clients=8)
    jr = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**kw))
    tm, tx, ty, tt = t_setup(num_clients=8, device="cpu")
    tr = t_build("heroes", tm, tx, ty, tt, cfg=TConfig(**kw), device="cpu")
    tr.state = dataclasses.replace(tr.state, params=from_jax_params(
        jax.device_get(jm.init_factorized(jax.random.PRNGKey(0))), "cpu"))
    jr.run(2)
    tr.run(2)

    def meta(payload):
        return json.loads(np.asarray(payload["meta"]).tobytes())

    jmeta = meta(j_state.state_to_payload(jr.state))
    tmeta = meta(t_state.state_to_payload(tr.state))
    assert tmeta.keys() == jmeta.keys()
    assert tmeta["rng_state"] == jmeta["rng_state"]
    assert tmeta["participation"] == jmeta["participation"]
    for k in ("round", "wall", "traffic", "traffic_up", "traffic_down",
              "in_flight", "has_sched"):
        assert tmeta[k] == jmeta[k], k
    n_test = int(tt["labels"].shape[0])
    assert len(tmeta["history"]) == len(jmeta["history"]) == 2
    for a, b in zip(jmeta["history"], tmeta["history"]):
        acc_a, acc_b = a.pop("accuracy"), b.pop("accuracy")
        assert a == b
        assert abs(acc_a - acc_b) <= 2.0 / n_test
    for k, v in jmeta["bound_state"].items():
        assert abs(tmeta["bound_state"][k] - v) <= 1e-3 * max(abs(v), 1e-12)
    # the arrays branch: same sched counters, params of the same layout
    jarr = j_state.state_to_payload(jr.state)["arrays"]
    tarr = t_state.state_to_payload(tr.state)["arrays"]
    for k in ("counters", "anchored"):
        np.testing.assert_array_equal(jarr["sched"][k], tarr["sched"][k])
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(
            jarr["params"])), tree_leaves(tarr["params"])):
        assert a.shape == tuple(b.shape)
