"""The cohort trainer and the client-batched composition kernels against
per-client calls, the sequential trainer and the JAX package.

Kernel level: each composition Function under ``torch.func.vmap`` over a
client axis equals per-client calls, forward and gradient, and holds the
same numpy inputs against ``jax.vmap`` of the JAX package's primitives
(``repro.kernels.ops``) at the tolerances of ``test_torch_kernels.py``
(2e-5; 2e-4 for conv_rank).  A spy holds what the CPU cannot otherwise
see: under ``vmap``, with and without grad, every plain kernel version
receives storage-backed operands with the whole cohort on a leading
client axis, the operands a CUDA kernel takes in one launch.

Trainer level: ``CohortTrainer.train_all`` equals
``SequentialTrainer.train_all`` at the reference's own tolerances
(``tests/test_engine.py``: params atol 1e-5 / rtol 1e-4, losses 1e-4,
estimates rtol 1e-2), and every scheme's cohort round, and the composed
transformer's cohort run, its sequential one.  The port's cohort runs
against the JAX package's are ``test_torch_cohort_runs.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.streaming import round_batch_indices as j_round_indices
from repro.data.streaming import stack_client_shards as j_stack
from repro.kernels import ops as jops
from repro_torch.convert import to_numpy
from repro_torch.core.calibration import RankPathCalibration as TCal
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.data.streaming import (ClientDataLoader, pack_arrays,
                                        round_batch_indices,
                                        stack_client_shards, unpack_tensors)
from repro_torch.fl import FLConfig as TConfig
from repro_torch.fl import build_image_setup as t_setup
from repro_torch.fl import build_runner as t_build
from repro_torch.fl import build_text_setup as t_text_setup
from repro_torch.fl.engine import (CohortTrainer, ProximalTrainer,
                                   SequentialTrainer)
from repro_torch.kernels import compose as cm
from repro_torch.kernels import conv_rank as cr
from repro_torch.kernels.compose import (compose, compose_dense_apply,
                                         rank_dense_apply)
from repro_torch.kernels.conv_rank import conv_rank_apply
from test_torch_engine import PIN, _record
from test_torch_schemes import BASE, _assert_params_close
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

DENSE_TOL = 2e-5
CONV_TOL = 2e-4
MODES = ("square", "grow_out", "grow_in")
SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "fedprox", "heroes")


def _rand(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _blocks(mode, p):
    return p * p if mode == "square" else p


def _conv_args(mode, p, C, seed):
    """Stacked (C, ...) x, basis, coeff of a 3x3 conv layer (I 6, R 8,
    O 5, two 6x6 images a client)."""
    g = 1 if mode == "grow_out" else p
    return _rand(seed, (C, 2, 6, 6, g * 6), (C, 9, 6, 8),
                 (C, _blocks(mode, p), 8, 5))


def _dense_args(mode, p, C, seed):
    """Stacked (C, ...) x, basis, coeff of a dense layer (16 rows, I 8,
    R 8, O 10: the CNN's head)."""
    g = 1 if mode == "grow_out" else p
    return _rand(seed, (C, 16, g * 8), (C, 1, 8, 8),
                 (C, _blocks(mode, p), 8, 10))


# each composition Function as (port fn, JAX fn, args maker, tolerance),
# per (mode, p, stride)
def _case(name, mode, p, stride):
    if name == "conv_rank":
        return (lambda x, v, u: conv_rank_apply(x, v, u, p, mode,
                                                stride=stride),
                lambda x, v, u: jops.conv_rank_apply(x, v, u, p, mode,
                                                     stride=stride),
                lambda C, s: _conv_args(mode, p, C, s), CONV_TOL)
    if name == "compose":
        return (compose, jops.compose,
                lambda C, s: _rand(s, (C, 9, 6, 8), (C, p * p, 8, 5)),
                DENSE_TOL)
    tfn, jfn = {"rank_dense_apply": (rank_dense_apply,
                                     jops.rank_dense_apply),
                "compose_dense_apply": (compose_dense_apply,
                                        jops.compose_dense_apply)}[name]
    return (lambda x, v, u: tfn(x, v, u, p, mode),
            lambda x, v, u: jfn(x, v, u, p, mode),
            lambda C, s: _dense_args(mode, p, C, s), DENSE_TOL)


def _function_cases():
    cases = []
    for mode in MODES:
        for p in (1, 2, 3):
            for stride in (1, 2):
                cases.append(("conv_rank", mode, p, stride))
            cases += [("rank_dense_apply", mode, p, 1),
                      ("compose_dense_apply", mode, p, 1)]
    cases += [("compose", "square", p, 1) for p in (1, 2, 3)]
    return cases


def _torch_vmap(fn, args):
    """fn under torch.func.vmap on stacked args: (y, grads of
    sum(sin(y)) w.r.t. the stacked args)."""
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = torch.func.vmap(fn)(*targs)
    grads = torch.autograd.grad(torch.sin(y).sum(), targs)
    return y.detach(), grads


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("name,mode,p,stride", _function_cases())
def test_function_under_vmap_equals_per_client_calls(name, mode, p, stride,
                                                      C):
    """vmap over a leading client axis (the cohort trainer's layout)
    equals per-client calls, forward and gradient."""
    tfn, _, make, tol = _case(name, mode, p, stride)
    args = make(C, 7 * C + p)
    y, grads = _torch_vmap(tfn, args)
    for c in range(C):
        one = [torch.from_numpy(a[c]).requires_grad_() for a in args]
        yc = tfn(*one)
        gc = torch.autograd.grad(torch.sin(yc).sum(), one)
        _close(y[c], yc.detach(), tol)
        for a, b in zip(grads, gc):
            _close(a[c], b, tol)


@pytest.mark.parametrize("name,mode,p,stride", _function_cases())
def test_function_under_vmap_matches_jax_vmap(name, mode, p, stride):
    """The same inputs through ``jax.vmap`` of the JAX package's
    primitive (as its ``test_conv_rank_apply_vmap_cohort`` and
    ``test_compose_dense_apply_vmap_cohort`` call them) and through the
    port's Function under ``torch.func.vmap``: forward and gradient."""
    tfn, jfn, make, tol = _case(name, mode, p, stride)
    args = make(3, 11 + p)
    y, grads = _torch_vmap(tfn, args)
    jargs = [jnp.asarray(a) for a in args]
    jy = jax.vmap(jfn)(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax.vmap(jfn)(*a))),
                      argnums=tuple(range(len(args))))(*jargs)
    _close(y, jy, tol)
    for a, b in zip(grads, jgrads):
        _close(a, b, tol)


def _cnn_batch(C, seed=3):
    x, = _rand(seed, (C, 16, 8, 8, 3), scale=1.0)
    labels = np.random.default_rng(seed).integers(0, 10, (C, 16))
    return {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)}


# the plain version each layer impl reaches: (conv, dense) layers
PLAIN = {"materialize": ("compose_ref", "compose_ref"),
         "rank_space": ("_fused_math", "_fwd_math"),
         "fused_compose": (None, "_compose_apply_math")}


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("impl,width", [("materialize", 2),
                                        ("rank_space", 3), ("auto", 2),
                                        ("auto", 3)])
def test_plain_versions_see_the_cohort_operands(monkeypatch, impl, width,
                                                grad):
    """The spy: under vmap, with and without grad, each plain kernel
    version the CNN's loss reaches runs once per layer for the whole
    cohort, on storage-backed operands (``data_ptr()`` works) with the
    client axis in front: what the CUDA wrappers launch on.  A batched
    tensor reaching a wrapper (which the card's launch cannot take), or a
    rule that loops over clients, fails here."""
    C = 3
    seen = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            for t in tensors:
                t.data_ptr()  # raises for a batched tensor
            seen.setdefault(name, []).append([tuple(t.shape)
                                              for t in tensors])
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(cm, "compose_ref")
    spy(cm, "_fwd_math")
    spy(cm, "_compose_apply_math")
    spy(cr, "_fused_math")
    model = t_setup(num_clients=4, device="cpu")[0]
    params = [model.reduce(model.init_factorized(s, "cpu"), width,
                           np.arange(width * width), np.arange(width))
              for s in range(C)]
    stacked = tree_map(lambda *a: torch.stack(a), *params)
    cal = TCal(**PIN) if impl == "auto" else None
    batch = _cnn_batch(C)

    def loss(p, b):
        w = model.prepare_weights(p, width, b, impl, cal)
        logits = model.forward(w, width, b)
        return torch.nn.functional.cross_entropy(logits, b["labels"])

    if grad:
        leaves = [t.requires_grad_() for t in tree_leaves(stacked)]
        torch.autograd.grad(torch.func.vmap(loss)(stacked, batch).sum(),
                            leaves)
    else:
        with torch.no_grad():
            torch.func.vmap(loss)(stacked, batch)
    want = {}
    impls = model.layer_impls(width, 16, impl, (16, 8, 8, 3), cal)
    for name, spec in model.specs.items():
        fn = PLAIN[impls[name]][0 if spec.ksq > 1 else 1]
        want[fn] = want.get(fn, 0) + 1
    assert {k: len(v) for k, v in seen.items()} == want
    for name, calls in seen.items():
        for shapes in calls:
            assert all(s[0] == C for s in shapes), (name, shapes)


# --------------------------------------------------------------------------
# host staging
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tau,tau_pad,estimate", [(3, None, True),
                                                  (3, 8, True),
                                                  (5, 5, False)])
def test_round_batch_indices_match_reference(tau, tau_pad, estimate):
    """Padded steps repeat the last batch and leave the RNG draws (the
    estimate batches too) as the reference draws them."""
    got = round_batch_indices(0, 2, 5, 40, tau, 16, estimate, tau_pad)
    want = j_round_indices(0, 2, 5, 40, tau, 16, estimate, tau_pad)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (tau_pad or tau, 16)


@pytest.mark.parametrize("step_leading", [False, True])
def test_stack_client_shards_matches_reference(step_leading):
    per = _rand(1, (4, 16, 3), (4, 16, 3), (4, 16, 3))
    (got,) = stack_client_shards(per, 1, step_leading=step_leading)
    want = j_stack(per, 1, step_leading=step_leading)
    assert len(want) == 1
    np.testing.assert_array_equal(got, want[0])


def test_packed_arrays_cross_in_one_buffer():
    arrays = [np.arange(30, dtype=np.float32).reshape(2, 3, 5),
              np.arange(7, dtype=np.int32), np.arange(6, dtype=np.int64),
              np.ones((3, 1), np.float32)]
    buf, layout = pack_arrays(arrays)
    assert buf.dtype == np.uint8 and buf.ndim == 1
    got = unpack_tensors(torch.from_numpy(buf), layout)
    for a, t in zip(arrays, got):
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)


def test_host_draw_round_matches_reference_streams():
    """``draw_round`` hands back host arrays under the RNG contract,
    padded steps included."""
    _, tx, ty, _ = t_setup(num_clients=4, device="cpu")
    loader = ClientDataLoader(tx, ty, "cpu")
    xs, ys, (xe, ye) = loader.draw_round(1, seed=0, rnd=3, tau=2,
                                         batch_size=8, estimate=True,
                                         tau_pad=4)
    idx, est_idx = j_round_indices(0, 3, 1, len(ty[1]), 2, 8, True, 4)
    assert isinstance(xs, np.ndarray) and xs.shape[:2] == (4, 8)
    np.testing.assert_array_equal(xs, np.asarray(tx[1])[idx])
    np.testing.assert_array_equal(ys, np.asarray(ty[1])[idx])
    np.testing.assert_array_equal(xe, np.asarray(tx[1])[est_idx])
    np.testing.assert_array_equal(ye, np.asarray(ty[1])[est_idx])


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "client-data-prefetch" and t.is_alive()]


@pytest.mark.parametrize("impl", ["materialize", "rank_space", "auto"])
def test_cohort_train_all_matches_sequential(impl):
    """Same assignments, same data order: the batched step reproduces the
    per-client sequential updates, in a group whose clients stop at
    different τ too."""
    tm, tx, ty, tt = t_setup(num_clients=8, device="cpu")
    eng = t_build("heroes", tm, tx, ty, tt, device="cpu", cfg=TConfig(
        num_clients=8, clients_per_round=4, forward_impl=impl, **PIN))
    _, assigns = eng.assignment.assign(eng.state, list(range(4)))
    widths = [a["width"] for a in assigns.values()]
    shared = max(set(widths), key=widths.count)  # 4 clients, 3 widths
    ragged = [n for n, a in assigns.items() if a["width"] == shared][0]
    assigns[ragged]["tau"] = 3
    seq, coh = SequentialTrainer(), CohortTrainer()
    seq.setup(eng)
    coh.setup(eng)
    r_seq = seq.train_all(eng.state, assigns)
    r_coh = coh.train_all(eng.state, assigns)
    assert list(r_seq) == list(r_coh)
    for n, a in r_seq.items():
        b = r_coh[n]
        for la, lb in zip(tree_leaves(to_numpy(a.params)),
                          tree_leaves(to_numpy(b.params))):
            np.testing.assert_allclose(lb, la, atol=1e-5, rtol=1e-4)
        assert abs(a.loss_before - b.loss_before) < 1e-4
        assert abs(a.loss_after - b.loss_after) < 1e-4
        assert a.estimates.keys() == b.estimates.keys() == {
            "L", "sigma_sq", "grad_sq"}
        for k in a.estimates:
            np.testing.assert_allclose(b.estimates[k], a.estimates[k],
                                       atol=1e-3, rtol=1e-2)


@pytest.fixture(scope="module")
def image_setup():
    return t_setup(num_clients=8, device="cpu")


def _run(setup, scheme, rounds, **knobs):
    tr = t_build(scheme, *setup, device="cpu", cfg=TConfig(**BASE, **knobs))
    log = _record(tr)
    tr.run(rounds)
    return tr, log


@pytest.mark.parametrize("scheme", SCHEMES)
def test_every_scheme_runs_a_cohort_round(scheme, image_setup):
    """One round of each scheme with ``trainer="cohort"`` equals its
    sequential round; FedProx keeps its own trainer."""
    knobs = dict(forward_impl="auto")
    seq, seq_log = _run(image_setup, scheme, 1, **knobs)
    coh, coh_log = _run(image_setup, scheme, 1, trainer="cohort", **knobs)
    want = ProximalTrainer if scheme == "fedprox" else CohortTrainer
    assert type(coh.trainer) is want
    a, b = seq.history[0], coh.history[0]
    assert (a.traffic_bytes, a.makespan, a.mean_tau, a.up_bytes) == \
        (b.traffic_bytes, b.makespan, b.mean_tau, b.up_bytes)
    assert abs(a.accuracy - b.accuracy) <= 2.0 / 500
    assert seq_log[0]["assign"] == coh_log[0]["assign"]
    for n, ea in seq_log[0]["est"].items():
        for k, v in ea.items():
            np.testing.assert_allclose(coh_log[0]["est"][n][k], v,
                                       atol=1e-4, rtol=1e-2)
    _assert_params_close(to_numpy(seq.params), to_numpy(coh.params))


def test_transformer_cohort_run_matches_sequential():
    """The composed transformer trains through the same batched step:
    its heroes rank_space cohort run equals its sequential run."""
    setup = t_text_setup(num_clients=8, max_width=3, seed=0,
                         model_name="transformer", device="cpu")
    runs = []
    for trainer in ("sequential", "cohort"):
        tr = t_build("heroes", *setup, device="cpu", cfg=TConfig(
            num_clients=8, clients_per_round=4, batch_size=8, eval_every=1,
            forward_impl="rank_space", trainer=trainer))
        log = _record(tr)
        tr.run(2)
        runs.append((tr, log))
    (seq, seq_log), (coh, coh_log) = runs
    for a, b in zip(seq.history, coh.history):
        assert (a.traffic_bytes, a.makespan, a.mean_tau) == \
            (b.traffic_bytes, b.makespan, b.mean_tau)
        assert a.accuracy == pytest.approx(b.accuracy, abs=1e-3)
    for ra, rb in zip(seq_log, coh_log):
        assert ra["assign"] == rb["assign"]
    _assert_params_close(to_numpy(seq.params), to_numpy(coh.params))


def test_cohort_trainer_releases_prefetch_on_error(monkeypatch,
                                                   image_setup):
    """A group's step that raises must not leave the prefetch worker
    blocked on its queue (the JAX package's
    ``test_cohort_trainer_closes_prefetch_on_error``).  HeteroFL's tiers
    give the round several cohort groups, so a worker starts."""
    tr = t_build("heterofl", *image_setup, device="cpu",
                 cfg=TConfig(**BASE, trainer="cohort"))
    staged = []
    prefetch = tr.data.prefetch

    def counting(items, fn):
        staged.append(len(list(items)))
        return prefetch(items, fn)

    def boom(*args, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(tr.data, "prefetch", counting)
    monkeypatch.setattr(CohortTrainer, "_train_group", boom)
    with pytest.raises(RuntimeError, match="boom"):
        tr.run_round()
    assert staged and staged[0] > 1
    for t in _prefetch_threads():
        t.join(timeout=5.0)
    assert not _prefetch_threads()
    tr.data.close()
