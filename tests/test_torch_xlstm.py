"""The port's xLSTM family (xlstm-125m) against the JAX package's, on the
smoke config in f32 (two layers: one mLSTM, one sLSTM), on the same
numpy inputs:

* every function of ``models/xlstm.py``: ``mlstm_dims``,
  ``_causal_conv``, ``mlstm_parallel`` (and its gradient),
  ``apply_mlstm``, ``init_mlstm_cache`` and ``apply_mlstm_decode`` (the
  carried C, n, m and conv state), ``init_slstm_state``,
  ``_slstm_cell``, ``apply_slstm`` and ``apply_slstm_decode``;
* the reference's forget-gate limit case
  (``tests/test_models_numerics.py::test_mlstm_forget_gate_limits``);
* the stack through ``models.model``: ``forward``, ``loss_fn`` and its
  gradient, ``remat``, teacher-forced ``serve_step`` against the
  reference's and the forward (states written in place), bf16 compute,
  Heroes composition on, the init tree, and both launchers on the CPU;
* at the full size, bf16 decode strays from the forward in the
  reference as in the port (and stays within 1e-3 in f32).

Tolerances: 1e-4 (``TOL``) on every f32 output and state, and on each
gradient leaf relative to its own largest entry; bf16 compute within
the zoo's bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import CompositionConfig as JComp
from repro.models import xlstm as jx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import CompositionConfig as TComp
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as tx
from torch_threads import one_thread  # noqa: F401
from torch_zoo_parity import (TOL, batch, cfgs, close, decode_both,
                              forward_both, grads_match, init_tree_matches,
                              launchers_run, params, tokens)

ARCH = "xlstm-125m"
# bf16 compute: the zoo's bf16 tolerance (tests/test_torch_dense.py)
BF16_TOL = 6e-2

_F32 = {}


def _f32():
    if not _F32:
        jcfg, tcfg = cfgs(ARCH, compute_dtype="float32")
        _F32["v"] = (jcfg, tcfg, *params(jcfg))
    return _F32["v"]


def _blocks():
    """(jcfg, tcfg, (ref mLSTM, port mLSTM), (ref sLSTM, port sLSTM)): the
    first superblock's layers of the f32 smoke model."""
    jcfg, tcfg, jp, tp = _f32()
    jm = jax.tree_util.tree_map(lambda a: a[0, 0], jp["stack"]["mlstm"])
    tm = tree_map(lambda a: a[0, 0], tp["stack"]["mlstm"])
    js = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["slstm"])
    ts = tree_map(lambda a: a[0], tp["stack"]["slstm"])
    return jcfg, tcfg, (jm, tm), (js, ts)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def test_mlstm_dims_match_reference():
    for get in ("get_smoke", "get_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert tx.mlstm_dims(t) == jx.mlstm_dims(j)
    assert tx.mlstm_dims(tconfigs.get_config(ARCH)) == (1536, 4, 192, 384)


def test_causal_conv_matches_reference():
    x, w, b = _x((2, 9, 12), 0), _x((4, 12), 1), _x((12,), 2)
    got = tx._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    close(got, jx._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))
    # causal: the first output sees only the first input
    close(got[:, 0], x[:, 0] * w[3] + b)


def test_mlstm_parallel_and_its_gradient_match_reference():
    B, T, H, dqk, dv = 2, 17, 3, 8, 12
    args = [_x((B, T, H, dqk), 3), _x((B, T, H, dqk), 4),
            _x((B, T, H, dv), 5), _x((B, T, H), 6), _x((B, T, H), 7, 3.0)]
    wgt = _x((B, T, H, dv), 8)
    jh = jx.mlstm_parallel(*map(jnp.asarray, args))
    jg = jax.grad(lambda *a: jnp.sum(jx.mlstm_parallel(*a) * wgt),
                  argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    th = tx.mlstm_parallel(*ta)
    close(th.detach(), jh)
    (th * torch.from_numpy(wgt)).sum().backward()
    for t, g in zip(ta, jg):
        close(t.grad, g)


def test_mlstm_forget_gate_limits():
    """f -> +inf keeps memory, i -> -inf ignores input (the reference's
    limit case): every output after t = 0 points along v_0, and the
    port's equals the reference's."""
    cfg = tconfigs.get_smoke(ARCH).replace(d_model=16, num_heads=2)
    B, T = 1, 6
    _, H, dqk, dv = tx.mlstm_dims(cfg)
    q, k, v = _x((B, T, H, dqk), 0), _x((B, T, H, dqk), 1), \
        _x((B, T, H, dv), 2)
    i_pre = np.full((B, T, H), -1e9, np.float32)
    i_pre[:, 0] = 0.0
    f_pre = np.full((B, T, H), 1e9, np.float32)
    args = (q, k, v, i_pre, f_pre)
    h = tx.mlstm_parallel(*map(torch.from_numpy, args)).numpy()
    close(h, jx.mlstm_parallel(*map(jnp.asarray, args)))
    h0, v0 = h[:, 1:], v[:, 0][:, None]
    cos = (h0 * v0).sum(-1) / (np.linalg.norm(h0, axis=-1)
                               * np.linalg.norm(v0, axis=-1) + 1e-9)
    assert np.all(np.abs(cos) > 0.99)


def test_apply_mlstm_matches_reference():
    jcfg, tcfg, (jm, tm), _ = _blocks()
    x = _x((2, 20, jcfg.d_model), 9, 0.5)
    close(tx.apply_mlstm(tm, tcfg, torch.from_numpy(x)),
          jx.apply_mlstm(jm, jcfg, jnp.asarray(x)))


def test_mlstm_decode_matches_reference_and_parallel_form():
    """Token by token from ``init_mlstm_cache``: each step's output and
    carried state (C, n, m, conv) against the reference's, and the
    outputs against the parallel form over the whole sequence."""
    jcfg, tcfg, (jm, tm), _ = _blocks()
    B, T = 2, 12
    x = _x((B, T, jcfg.d_model), 10, 0.5)
    jc = jx.init_mlstm_cache(jcfg, B, jnp.float32)
    tc = tx.init_mlstm_cache(tcfg, B, torch.float32, "cpu")
    for name, a in _np(jc).items():
        np.testing.assert_array_equal(tc[name].numpy(), a, err_msg=name)
    outs = []
    for t in range(T):
        jy, jc = jx.apply_mlstm_decode(jm, jcfg, jnp.asarray(x[:, t:t + 1]),
                                       jc)
        ty, tc = tx.apply_mlstm_decode(tm, tcfg,
                                       torch.from_numpy(x[:, t:t + 1]), tc)
        close(ty, jy)
        for name, a in _np(jc).items():
            close(tc[name], a)
        outs.append(ty)
    close(torch.cat(outs, 1),
          tx.apply_mlstm(tm, tcfg, torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def test_slstm_cell_and_state_match_reference():
    jcfg, tcfg, _, (js, ts) = _blocks()
    B, d = 3, jcfg.d_model
    jst = jx.init_slstm_state(jcfg, B, jnp.float32)
    tst = tx.init_slstm_state(tcfg, B, torch.float32, "cpu")
    for name, a in _np(jst).items():
        np.testing.assert_array_equal(tst[name].numpy(), a, err_msg=name)
        assert tst[name].dtype == torch.float32
    assert tx.init_slstm_state(tcfg, B, torch.bfloat16)["h"].dtype == \
        torch.bfloat16
    for step in range(3):
        xg = _x((B, 4 * d), 11 + step)
        jst, jh = jx._slstm_cell(js, jcfg, jnp.asarray(xg), jst)
        tst, th = tx._slstm_cell(ts, tcfg, torch.from_numpy(xg), tst)
        close(th, jh)
        for name, a in _np(jst).items():
            close(tst[name], a)


def test_apply_slstm_and_decode_match_reference():
    jcfg, tcfg, _, (js, ts) = _blocks()
    B, T = 2, 14
    x = _x((B, T, jcfg.d_model), 12, 0.5)
    full = tx.apply_slstm(ts, tcfg, torch.from_numpy(x))
    close(full, jx.apply_slstm(js, jcfg, jnp.asarray(x)))
    jst = jx.init_slstm_state(jcfg, B, jnp.float32)
    tst = tx.init_slstm_state(tcfg, B, torch.float32, "cpu")
    outs = []
    for t in range(T):
        jy, jst = jx.apply_slstm_decode(js, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jst)
        ty, tst = tx.apply_slstm_decode(ts, tcfg,
                                        torch.from_numpy(x[:, t:t + 1]), tst)
        close(ty, jy)
        outs.append(ty)
    for name, a in _np(jst).items():
        close(tst[name], a)
    close(torch.cat(outs, 1), full.numpy())


# ---------------------------------------------------------------------------
# the stack through models.model
# ---------------------------------------------------------------------------


def test_forward_and_loss_match_reference():
    jcfg, tcfg, jp, tp = _f32()
    assert tp["stack"]["mlstm"]["conv_w"].shape[:2] == (1, 1)
    toks = tokens(jcfg, 2, 40)
    tl, jl, taux, jaux = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    assert tl.shape == (2, 40, tcfg.vocab) and taux == 0.0 == jaux
    close(tl, jl)


def test_loss_fn_gradients_match_reference():
    jcfg, tcfg, jp, tp = _f32()
    grads_match(jcfg, tcfg, jp, tp, tokens(jcfg, 2, 24, seed=4))


def test_remat_gives_the_same_gradients():
    _, tcfg, _, tp = _f32()
    toks = tokens(tcfg, 2, 16, seed=8)
    labels = np.roll(toks, -1, axis=1)
    grads = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
        loss, _ = tmodel.loss_fn(p, tcfg.replace(remat=remat),
                                 batch(toks, labels, True))
        loss.backward()
        grads.append([t.grad for t in tree_leaves(p)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("layers", [2, 4])
def test_serve_steps_match_reference_and_forward(layers):
    """Teacher-forced decode through the recurrent states (written in
    place) against the reference's and the port's forward; at 4 layers
    two superblocks, each one mLSTM and one sLSTM."""
    jcfg, tcfg = cfgs(ARCH, compute_dtype="float32", num_layers=layers)
    jp, tp = params(jcfg, seed=layers)
    toks = tokens(jcfg, 2, 12, seed=1)
    dec, jdec, tcache, jcache = decode_both(jcfg, tcfg, jp, tp, toks, 14)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True))
    close(dec, jdec)
    close(dec, full.numpy())
    nsuper = layers // 2
    assert tcache["mlstm"]["C"].shape[:2] == (nsuper, 1)
    for part in ("mlstm", "slstm"):
        for name, a in _np(jcache[part]).items():
            close(tcache[part][name], a)


def test_bf16_forward_matches_reference():
    jcfg, tcfg = cfgs(ARCH)
    assert tcfg.cdtype == torch.bfloat16
    jp, tp = params(jcfg, seed=3)
    toks = tokens(jcfg, 2, 24, seed=3)
    tl, jl, _, _ = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    assert tl.dtype == torch.bfloat16
    close(tl, jl, BF16_TOL)
    cache = tmodel.init_cache(tcfg, 2, 24, "cpu")
    assert cache["mlstm"]["C"].dtype == torch.bfloat16
    assert cache["slstm"]["c"].dtype == torch.float32


def test_full_size_bf16_decode_drifts_as_the_references(capsys):
    """At xlstm-125m's full size (12 layers, f32 params, 2 x 8 tokens)
    bf16 rounding grows through the recurrences until decode parts from
    the forward by a large share of max |logits|, in the reference as in
    the port: the port's gap is at most twice the reference's own.  In
    f32 both packages' gaps stay under 1e-3.  This is why the chip
    smoke's path (s) holds its step check in f32."""
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        jcfg, tcfg = (c.replace(compute_dtype=dtype) for c in (
            jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)))
        jp, tp = params(jcfg)
        toks = tokens(jcfg, 2, 8)
        tl, jl, _, _ = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
        dec, jdec, _, _ = decode_both(jcfg, tcfg, jp, tp, toks, 8)
        scale = max(1.0, float(np.abs(jl).max()))
        gaps[dtype] = (float((dec - tl).abs().max()) / scale,
                       float(np.abs(jdec - jl).max()) / scale)
    with capsys.disabled():
        print(f"\n  {ARCH} decode vs forward, max |diff| / max |logits| "
              f"(port, reference): {gaps}")
    port, ref = gaps["bfloat16"]
    assert ref > 0.1 and port <= 2 * ref, gaps
    assert max(gaps["float32"]) < 1e-3, gaps


def test_composed_forward_matches_reference():
    """Heroes composition on (max width 2, every projection factorized),
    forward and gradient."""
    jcfg, tcfg = cfgs(ARCH, compute_dtype="float32",
                      composition=JComp(enabled=True, max_width=2))
    tcfg = tcfg.replace(composition=TComp(enabled=True, max_width=2))
    jp, tp = params(jcfg, seed=2)
    assert "basis" in tp["stack"]["mlstm"]["up"]
    assert "basis" in tp["stack"]["slstm"]["ff_up"]
    toks = tokens(jcfg, 2, 20, seed=2)
    tl, jl, _, _ = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    close(tl, jl)
    grads_match(jcfg, tcfg, jp, tp, toks)
    init_tree_matches(jcfg, tcfg)


def test_init_matches_reference_tree():
    tp = init_tree_matches(*cfgs(ARCH))
    assert tp["stack"]["mlstm"]["wif"]["w"].dtype == torch.float32
    assert tp["stack"]["slstm"]["bias"].dtype == torch.float32
    jcfg, tcfg = cfgs(ARCH, param_dtype="bfloat16", num_layers=4)
    tp = init_tree_matches(jcfg, tcfg)
    assert tp["stack"]["mlstm"]["wif"]["w"].dtype == torch.float32
    assert tp["stack"]["slstm"]["r"].dtype == torch.bfloat16


def test_launchers_serve_and_train(capsys):
    launchers_run(ARCH, capsys)
