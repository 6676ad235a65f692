"""The port's MoE family (olmoe-1b-7b, kimi-k2-1t-a32b) against the JAX
package's, on the smoke configs in f32, on the same numpy inputs:

* ``capacity``, ``router_topk`` (probabilities, gates and expert ids;
  tied probabilities rank the lower expert id first, as
  ``jax.lax.top_k``), ``make_combine`` (the combine tensor, with tokens
  dropped past capacity, and the aux loss) and ``expert_ffn``;
* ``apply_moe`` in its grouped case (one group per row: S = 512, B > 1)
  and its ungrouped one, with and without the shared expert, and its
  gradient; ``apply_moe_sorted`` against the reference's and against
  ``apply_moe``;
* olmoe and kimi through ``models.model``: ``forward``, ``loss_fn`` (the
  aux loss included) and its gradient, ``parallel_block``, ``remat``,
  prefill and teacher-forced ``serve_step`` against the reference's and
  (with ``capacity_factor=8``: no token dropped) against the forward;
  kimi with the sliding window and with the int8 KV cache, and with bf16
  params (the router stays f32);
* the init trees and both launchers on the CPU.

Tolerances: 1e-4 (``TOL``) on every f32 output and on each gradient
leaf relative to its own largest entry; the expert ids and the kept
slots are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from torch_threads import one_thread  # noqa: F401
from torch_zoo_parity import (TOL, batch, cfgs, close, decode_both,
                              forward_both, grads_match, init_tree_matches,
                              launchers_run, params, tokens)

MOE = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
NO_DROP = {"capacity_factor": 8.0}
# bf16 params and compute: the zoo's bf16 tolerance (tests/test_torch_dense.py)
BF16_TOL = 6e-2

_F32 = {}


def _f32(arch):
    """(jcfg, tcfg, reference params, port params), f32 compute, made once
    per arch for the module."""
    if arch not in _F32:
        jcfg, tcfg = cfgs(arch, compute_dtype="float32")
        _F32[arch] = (jcfg, tcfg, *params(jcfg))
    return _F32[arch]


def _layer_params(arch):
    """``arch``'s f32 smoke configs and its first MoE layer's ``moe``
    params: (jcfg, tcfg, reference params, port params)."""
    jcfg, tcfg, jp, tp = _f32(arch)
    jl = jax.tree_util.tree_map(lambda a: a[0],
                                jp["stack"]["moe_layers"]["moe"])
    tl = tree_map(lambda a: a[0], tp["stack"]["moe_layers"]["moe"])
    return jcfg, tcfg, jl, tl


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the dispatch's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_reference(arch):
    for n in (1, 4, 7, 33, 64, 512, 2048, 4096):
        for cf in (1.0, 1.25, 8.0):
            j, t = cfgs(arch, moe={"capacity_factor": cf})
            assert tmoe.capacity(n, t) == jmoe.capacity(n, j)
        assert tmoe.capacity(n, tconfigs.get_config(arch)) == \
            jmoe.capacity(n, jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", MOE)
def test_router_topk_matches_reference(arch):
    jcfg, tcfg, jl, tl = _layer_params(arch)
    x = _x((3, 40, jcfg.d_model), 1)
    jp, jg, ji = jmoe.router_topk(jl["router"], jnp.asarray(x), jcfg)
    tp, tg, ti = tmoe.router_topk(tl["router"], torch.from_numpy(x), tcfg)
    assert tp.dtype == torch.float32 and ti.shape == (3, 40,
                                                      jcfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tp, jp)
    close(tg, jg)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_topk_ties_rank_the_lower_expert_first():
    """Equal router columns give equal probabilities: the top-k order is
    then the expert order, in both packages (``make_combine`` fills the
    slots in that order)."""
    jcfg, tcfg = cfgs("olmoe-1b-7b", moe={"num_experts": 6, "top_k": 3})
    w = _x((jcfg.d_model, 6), 2)
    w[:, 1] = w[:, 3] = w[:, 4] = w[:, 0]  # four equal experts
    x = _x((5, jcfg.d_model), 3)
    _, _, ji = jmoe.router_topk({"w": jnp.asarray(w)}, jnp.asarray(x), jcfg)
    _, _, ti = tmoe.router_topk({"w": torch.from_numpy(w)},
                                torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ties = [row for row in ti.tolist() if set(row) <= {0, 1, 3, 4}]
    assert ties and all(row == sorted(row) for row in ties)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_make_combine_matches_reference(cf):
    """The combine tensor and the aux loss, with tokens dropped past
    capacity (cf 0.5), at the default capacity and with none dropped
    (8.0)."""
    jcfg, tcfg = cfgs("olmoe-1b-7b", moe={"capacity_factor": cf})
    _, _, jl, tl = _layer_params("olmoe-1b-7b")
    x = _x((48, jcfg.d_model), 4)
    cap = jmoe.capacity(48, jcfg)
    jp, jg, ji = jmoe.router_topk(jl["router"], jnp.asarray(x), jcfg)
    tp, tg, ti = tmoe.router_topk(tl["router"], torch.from_numpy(x), tcfg)
    jc, ja = jmoe.make_combine(jp, jg, ji, jcfg, cap)
    tc, ta = tmoe.make_combine(tp, tg, ti, tcfg, cap)
    assert tc.shape == (48, jcfg.moe.num_experts, cap)
    np.testing.assert_array_equal(tc.numpy() > 0, np.asarray(jc) > 0)
    close(tc, jc)
    close(ta, ja)
    kept = int((tc > 0).sum())
    if cf == 0.5:
        assert kept < 48 * jcfg.moe.top_k  # some slots dropped
    elif cf == 8.0:
        assert kept == 48 * jcfg.moe.top_k
    # over leading group axes: each group as on its own
    xs = _x((3, 16, jcfg.d_model), 5)
    tp3, tg3, ti3 = tmoe.router_topk(tl["router"], torch.from_numpy(xs),
                                     tcfg)
    cap16 = tmoe.capacity(16, tcfg)
    tc3, ta3 = tmoe.make_combine(tp3, tg3, ti3, tcfg, cap16)
    for g in range(3):
        jcg, jag = jmoe.make_combine(*jmoe.router_topk(
            jl["router"], jnp.asarray(xs[g]), jcfg), jcfg, cap16)
        close(tc3[g], jcg)
        close(ta3[g], jag)


def test_expert_ffn_matches_reference():
    for arch in MOE:
        jcfg, tcfg, jl, tl = _layer_params(arch)
        xec = _x((jcfg.moe.num_experts, 8, jcfg.d_model), 6)
        close(tmoe.expert_ffn(tl, tcfg, torch.from_numpy(xec)),
              jmoe.expert_ffn(jl, jcfg, jnp.asarray(xec)))


@pytest.mark.parametrize("shape", [(2, 512), (1, 512), (3, 20)],
                         ids=["grouped", "one-row", "ungrouped"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, shape):
    """``apply_moe`` grouped (a dispatch group per row: capacity from 512
    tokens) and ungrouped (one group over B*S), olmoe without the shared
    expert and kimi with it; and its gradient w.r.t. x and the expert
    tensors."""
    jcfg, tcfg, jl, tl = _layer_params(arch)
    assert ("shared" in tl) == (arch == "kimi-k2-1t-a32b")
    x = 0.5 * _x((*shape, jcfg.d_model), 7)
    jy, ja = jmoe.apply_moe(jl, jcfg, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tl = tree_map(lambda t: t.detach().clone().requires_grad_(), tl)
    ty, ta = tmoe.apply_moe(tl, tcfg, tx)
    close(ty.detach(), jy)
    close(ta.detach(), ja)
    # the gradient of a weighted sum of the output plus the aux loss
    wgt = _x(x.shape, 8)

    def jloss(p, xx):
        y, a = jmoe.apply_moe(p, jcfg, xx)
        return jnp.sum(y * wgt) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(x))
    (ty * torch.from_numpy(wgt)).sum().add(ta).backward()
    close(tx.grad, jgx)
    for name in ("gate", "up", "down"):
        want = np.asarray(jgp[name])
        np.testing.assert_allclose(tl[name].grad.numpy(), want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=name)
    want = np.asarray(jgp["router"]["w"])
    np.testing.assert_allclose(tl["router"]["w"].grad.numpy(), want,
                               rtol=TOL, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(2, 512), (3, 20)],
                         ids=["grouped", "ungrouped"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_sorted_matches_reference_and_dense_dispatch(arch, shape):
    jcfg, tcfg, jl, tl = _layer_params(arch)
    x = 0.5 * _x((*shape, jcfg.d_model), 9)
    jy, ja = jmoe.apply_moe_sorted(jl, jcfg, jnp.asarray(x))
    with torch.no_grad():
        ty, ta = tmoe.apply_moe_sorted(tl, tcfg, torch.from_numpy(x))
        dy, da = tmoe.apply_moe(tl, tcfg, torch.from_numpy(x))
    close(ty, jy)
    close(ta, ja)
    close(ty, dy.numpy())
    close(ta, da.numpy())


# ---------------------------------------------------------------------------
# the stack through models.model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg, jp, tp = _f32(arch)
    assert ("dense_layers" in tp["stack"]) == (arch == "kimi-k2-1t-a32b")
    toks = tokens(jcfg, 2, 40)
    labels = np.roll(toks, -1, axis=1)
    tl, jl, taux, jaux = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    assert tl.shape == (2, 40, tcfg.vocab)
    close(tl, jl)
    assert taux > 0
    np.testing.assert_allclose(taux, jaux, rtol=TOL)
    jloss, jmet = jmodel.loss_fn(jp, jcfg, batch(toks, labels))
    with torch.no_grad():
        loss, met = tmodel.loss_fn(tp, tcfg, batch(toks, labels, True))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(met["ce"]) + float(met["aux"]),
                               float(loss), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_gradients_match_reference(arch):
    jcfg, tcfg, jp, tp = _f32(arch)
    met = grads_match(jcfg, tcfg, jp, tp, tokens(jcfg, 2, 24, seed=4))
    assert float(met["aux"]) > 0


def test_parallel_block_and_remat():
    """The MoE branch of ``parallel_block`` against the reference, and
    ``remat`` (each layer under ``torch.utils.checkpoint``) giving the
    same gradients as without it."""
    jcfg, tcfg = cfgs("kimi-k2-1t-a32b", compute_dtype="float32",
                      parallel_block=True)
    jp, tp = params(jcfg, seed=2)
    toks = tokens(jcfg, 2, 16, seed=2)
    tl, jl, taux, jaux = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    close(tl, jl)
    np.testing.assert_allclose(taux, jaux, rtol=TOL)
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


@pytest.mark.parametrize("arch", MOE)
def test_serve_steps_match_reference_and_forward(arch):
    """Teacher-forced decode against the reference's at the default
    capacity, and in the no-drop regime also against the port's own
    forward (capacity drops differ between a 24-token forward and a
    2-token step by construction)."""
    jcfg, tcfg, jp, tp = _f32(arch)
    toks = tokens(jcfg, 2, 12, seed=1)
    dec, jdec, _, _ = decode_both(jcfg, tcfg, jp, tp, toks, 14)
    close(dec, jdec)
    jcfg, tcfg = cfgs(arch, moe=NO_DROP, compute_dtype="float32")
    dec, jdec, _, _ = decode_both(jcfg, tcfg, jp, tp, toks, 14)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True))
        pre, cache = tmodel.prefill(tp, tcfg, batch(toks, torch_side=True),
                                    "c")
    assert cache == "c"
    close(dec, jdec)
    close(dec, full.numpy())
    torch.testing.assert_close(pre, full, atol=0, rtol=0)


def test_kimi_sliding_window_and_int8_cache():
    """kimi's smoke config with a 16-slot sliding window (decoded past the
    wrap) and with the int8 KV cache, each against the reference's
    decode; the window also against the port's windowed forward."""
    arch = "kimi-k2-1t-a32b"
    jcfg, tcfg = cfgs(arch, moe=NO_DROP, compute_dtype="float32",
                      sliding_window=16)
    jp, tp = params(jcfg, seed=3)
    toks = tokens(jcfg, 2, 36, seed=5)
    dec, jdec, tcache, _ = decode_both(jcfg, tcfg, jp, tp, toks, 64)
    assert tcache["k"].shape[2] == 16
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True))
    close(dec, jdec)
    close(dec, full.numpy())
    jcfg, tcfg = cfgs(arch, compute_dtype="float32", kv_cache_quant="int8")
    toks = tokens(jcfg, 2, 8, seed=12)
    dec, jdec, tcache, jcache = decode_both(jcfg, tcfg, jp, tp, toks, 16)
    assert tcache["k"].dtype == torch.int8
    # two layers (dense, then MoE), cache stacked in that order
    assert tcache["k"].shape[0] == 2
    close(dec, jdec)
    np.testing.assert_array_equal(tcache["k"].numpy(),
                                  np.asarray(jcache["k"]))


def test_kimi_bf16_params_match_reference():
    """kimi's own param type, bf16 (the router stays f32), carried across
    bf16 and run in bf16 within the zoo's bf16 tolerance."""
    jcfg, tcfg = cfgs("kimi-k2-1t-a32b", param_dtype="bfloat16")
    jp, tp = params(jcfg, seed=6)
    moe_p = tp["stack"]["moe_layers"]["moe"]
    assert moe_p["gate"].dtype == torch.bfloat16
    assert moe_p["router"]["w"].dtype == torch.float32
    toks = tokens(jcfg, 2, 16, seed=6)
    tl, jl, taux, jaux = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    assert tl.dtype == torch.bfloat16
    close(tl, jl, BF16_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=BF16_TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_init_matches_reference_tree(arch, param_dtype):
    jcfg, tcfg = cfgs(arch, param_dtype=param_dtype)
    tp = init_tree_matches(jcfg, tcfg)
    assert tp["stack"]["moe_layers"]["moe"]["router"]["w"].dtype == \
        torch.float32


def test_chunked_draws_fill_every_entry(monkeypatch):
    """A tensor past ``DRAW_CHUNK`` elements is drawn chunk by chunk into
    its own storage (no f32 copy of a bf16 stack): every entry drawn,
    with the requested scale, and one layer stacked without a copy."""
    from repro_torch.models import module

    monkeypatch.setattr(module, "DRAW_CHUNK", 1000)
    gen = torch.Generator().manual_seed(0)
    t = module.normal(gen, (7, 30, 11), torch.bfloat16, 0.5)
    assert t.shape == (7, 30, 11) and t.dtype == torch.bfloat16
    assert bool((t != 0).all())
    assert abs(float(t.float().std()) - 0.5) < 0.05
    jcfg, tcfg = cfgs("kimi-k2-1t-a32b", param_dtype="bfloat16")
    tp = tmodel.init(0, tcfg, "cpu")
    gate = tp["stack"]["moe_layers"]["moe"]["gate"]
    assert gate.shape[0] == 1 and not gate._is_view()


@pytest.mark.parametrize("arch", MOE)
def test_launchers_serve_and_train(arch, capsys):
    launchers_run(arch, capsys)
