"""The port's dense family (gemma-2b, stablelm-3b, deepseek-coder-33b,
granite-34b) against the JAX package's, on the smoke configs.

The reference's parameters (``repro.models.model.init``) are carried
across with ``convert.from_jax_params`` and the same numpy tokens go
through both packages:

* ``forward`` logits and ``loss_fn`` in f32 within 1e-4 and in bf16
  within the zoo's bf16 tolerance, and ``loss_fn``'s gradient leaf by
  leaf against ``jax.grad`` (1e-4 of each leaf's largest entry);
* teacher-forced ``serve_step`` against the reference's and against the
  port's own ``forward`` (the reference's ``test_decode_matches_forward``)
  at 1e-4 in f32;
* ``parallel_block=True``, Heroes composition at max widths 1 and 2 (p =
  P), ``skip_blocks``, and the ``embeddings`` / ``positions`` batch keys;
* the sliding-window variant: a ring of 16 slots at ``cache_len`` 900,
  and a teacher-forced run past the wrap against the reference's logits
  and the port's windowed forward (gemma and zamba2, as the reference's
  ``test_smoke_sliding_window_variant``), and two planted ring faults
  that the same comparison must catch;
* the int8 KV cache: ``_quantize_kv`` equal to the reference's on the
  same input, an int8 decode's logits against the reference's int8
  decode, its int8 caches equal to the reference's and its scales
  within 1e-5, and the
  reference's 5 % bound against the compute-type cache;
* ``configs.config_for_shape`` for every arch and shape.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import CompositionConfig as JComp
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs.base import CompositionConfig as TComp
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from torch_threads import one_thread  # noqa: F401
from torch_zoo_parity import batch as _batch
from torch_zoo_parity import cfgs as _cfgs
from torch_zoo_parity import close as _close
from torch_zoo_parity import decode_both as _decode_both
from torch_zoo_parity import grads_match
from torch_zoo_parity import params as _params
from torch_zoo_parity import tokens as _tokens

DENSE = ("gemma-2b", "stablelm-3b", "deepseek-coder-33b", "granite-34b")
TOL = 1e-4
# bf16 compute: the packages round activations to bf16 at different
# places (the port's CPU attention keeps f32 scores and sums), about 2-3
# bf16 ulps of the logits after two layers (the zoo's tolerance)
BF16_TOL = 6e-2
# gradients in f32, each leaf relative to its own largest entry
GRAD_TOL = 1e-4


_F32 = {}


def _f32(arch):
    """(jcfg, tcfg, reference params, port params), f32 compute, made once
    per arch for the module."""
    if arch not in _F32:
        jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
        _F32[arch] = (jcfg, tcfg, *_params(jcfg))
    return _F32[arch]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg, jp, tp = _f32(arch)
    toks = _tokens(jcfg, 2, 40)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks))
    jloss, _ = jmodel.loss_fn(jp, jcfg, _batch(toks, labels))
    with torch.no_grad():
        tl, aux = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
        loss, met = tmodel.loss_fn(tp, tcfg, _batch(toks, labels, True))
    assert tl.shape == (2, 40, tcfg.vocab) and float(aux) == 0.0
    _close(tl, jl, TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert float(met["ce"]) == float(loss)


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_forward_and_loss_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.cdtype == torch.bfloat16
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 40, seed=3)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks))
    jloss, _ = jmodel.loss_fn(jp, jcfg, _batch(toks, labels))
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
        loss, _ = tmodel.loss_fn(tp, tcfg, _batch(toks, labels, True))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl.astype(jnp.float32), BF16_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_gradients_match_reference(arch):
    jcfg, tcfg, jp, tp = _f32(arch)
    grads_match(jcfg, tcfg, jp, tp, _tokens(jcfg, 2, 40, seed=4), GRAD_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_steps_match_reference_and_forward(arch):
    jcfg, tcfg, jp, tp = _f32(arch)
    toks = _tokens(jcfg, 2, 12, seed=1)
    dec, jdec, _, _ = _decode_both(jcfg, tcfg, jp, tp, toks, 14)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(dec, jdec, TOL)
    _close(dec, full.numpy(), TOL)


def test_prefill_and_step_functions():
    from repro_torch.launch import steps

    jcfg, tcfg, _, tp = _f32("gemma-2b")
    toks = torch.from_numpy(_tokens(tcfg, 2, 10))
    cache = tmodel.init_cache(tcfg, 2, 12, "cpu")
    lg, c2 = tmodel.prefill(tp, tcfg, {"tokens": toks}, cache)
    assert c2 is cache and not lg.requires_grad
    torch.testing.assert_close(steps.make_prefill(tcfg)(tp, {
        "tokens": toks}), lg, atol=0, rtol=0)
    with torch.no_grad():
        want, _ = tmodel.serve_step(tp, tcfg, {"tokens": toks[:, :1]},
                                    tmodel.init_cache(tcfg, 2, 12, "cpu"), 0)
    got, _ = steps.make_serve_step(tcfg)(tp, {"tokens": toks[:, :1]},
                                         cache, 0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_parallel_block_matches_reference():
    jcfg, tcfg = _cfgs("stablelm-3b", compute_dtype="float32",
                       parallel_block=True)
    jp, tp = _params(jcfg, seed=2)
    toks = _tokens(jcfg, 2, 10, seed=2)
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks))
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(tl, jl, TOL)
    dec, jdec, _, _ = _decode_both(jcfg, tcfg, jp, tp, toks, 10)
    _close(dec, jdec, TOL)
    _close(dec, tl.numpy(), TOL)


@pytest.mark.parametrize("max_width", [1, 2])
def test_composed_forward_matches_reference(max_width):
    jcfg, tcfg = _cfgs("gemma-2b", compute_dtype="float32",
                       composition=JComp(enabled=True, max_width=max_width))
    tcfg = tcfg.replace(composition=TComp(enabled=True, max_width=max_width))
    jp, tp = _params(jcfg, seed=max_width)
    assert "basis" in tp["stack"]["layers"]["attn"]["wq"]
    toks = _tokens(jcfg, 2, 20, seed=max_width)
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks))
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(tl, jl, TOL)
    init = tmodel.init(0, tcfg, "cpu")
    assert tree_map(lambda t: tuple(t.shape), init) == tree_map(
        lambda t: tuple(t.shape), tp)


def test_skip_blocks_and_batch_keys_match_reference():
    """``skip_blocks`` (the chunked softmax skipping masked KV chunks),
    and the ``embeddings`` / ``positions`` batch keys."""
    jcfg, tcfg, jp, tp = _f32("deepseek-coder-33b")
    toks = _tokens(jcfg, 2, 72, seed=6)  # three 32-token chunks
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks), skip_blocks=True)
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True),
                               skip_blocks=True)
        plain, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(tl, jl, TOL)
    _close(tl, plain.numpy(), TOL)
    rng = np.random.default_rng(7)
    emb = (0.1 * rng.standard_normal((2, 9, jcfg.d_model))).astype(np.float32)
    pos = np.stack([np.arange(9) + 5, np.arange(9) * 2]).astype(np.int32)
    jl, _ = jmodel.forward(jp, jcfg, {"embeddings": jnp.asarray(emb),
                                      "positions": jnp.asarray(pos)})
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, {
            "embeddings": torch.from_numpy(emb),
            "positions": torch.from_numpy(pos)})
    _close(tl, jl, TOL)


def test_gemma_embedding_scale_rounds_in_the_compute_type():
    """gemma's sqrt(d) = 16 at the smoke width, 45.25... at full width:
    in bf16 the scale itself is rounded first (45.25 -> 45.25, exact),
    as ``jnp.asarray(d**0.5, cdtype)``; the embeddings then match."""
    for d in (256, 2048, 300):
        jcfg, tcfg = _cfgs("gemma-2b", d_model=d)
        table = np.random.default_rng(d).standard_normal(
            (jcfg.vocab, d)).astype(np.float32)
        toks = _tokens(jcfg, 2, 5, seed=d)
        want = jmodel._input_embeddings({"embed": {"table": jnp.asarray(
            table)}}, jcfg, {"tokens": jnp.asarray(toks)})
        got = tmodel._input_embeddings({"embed": {"table": torch.from_numpy(
            table)}}, tcfg, {"tokens": torch.from_numpy(toks)})
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
    while a gradient is recorded: memory, not numbers."""
    _, tcfg, _, tp = _f32("granite-34b")
    toks = _tokens(tcfg, 2, 16, seed=8)
    labels = np.roll(toks, -1, axis=1)
    grads = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
        loss, _ = tmodel.loss_fn(p, tcfg.replace(remat=remat),
                                 _batch(toks, labels, True))
        loss.backward()
        grads.append([t.grad for t in tree_leaves(p)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# sliding window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b"])
def test_sliding_window_ring_matches_reference(arch):
    window, B = 16, 2
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32", sliding_window=window)
    jp, tp = _params(jcfg, seed=3)
    # the ring is bounded by the window; a step at cache_len 900
    jcache = jmodel.init_cache(jcfg, B, 1024)
    tcache = tmodel.init_cache(tcfg, B, 1024, "cpu")
    kv = tcache["kv"] if tcfg.family == "hybrid" else tcache
    assert kv["k"].shape[2] == window
    one = np.ones((B, 1), np.int32)
    jl, _ = jmodel.serve_step(jp, jcfg, {"tokens": jnp.asarray(one)}, jcache,
                              jnp.int32(900))
    with torch.no_grad():
        tl, _ = tmodel.serve_step(tp, tcfg, {"tokens": torch.from_numpy(one)},
                                  tcache, 900)
    assert bool(torch.isfinite(tl).all())
    _close(tl, jl, TOL)
    # teacher-forced past the wrap: the reference's logits and the
    # port's windowed forward
    toks = _tokens(jcfg, B, 40, seed=5)
    dec, jdec, _, _ = _decode_both(jcfg, tcfg, jp, tp, toks, 64)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(dec, jdec, TOL)
    _close(dec, full.numpy(), TOL)


@pytest.mark.parametrize("fault", ["one_slot_wide", "stale_slot"])
def test_ring_check_fails_planted_faults(fault):
    """The teacher-forced ring check tells a broken ring from rounding: a
    ring one slot too wide (window 17 against the forward's 16), or one
    slot put back stale after a step past the wrap, agrees with the
    windowed forward up to the fault and misses it by far more than TOL
    after."""
    window, B, T = 16, 2, 40
    stale_at = window + 4 if fault == "stale_slot" else None
    _, tcfg = _cfgs("gemma-2b", compute_dtype="float32",
                    sliding_window=window)
    run_cfg = (tcfg.replace(sliding_window=window + 1)
               if fault == "one_slot_wide" else tcfg)
    tp = tmodel.init(3, tcfg, "cpu")
    toks = torch.from_numpy(_tokens(tcfg, B, T, seed=5))
    steps = []
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, {"tokens": toks})
        cache = tmodel.init_cache(run_cfg, B, T, "cpu")
        smax = cache["k"].shape[2]
        for t in range(T):
            if t == stale_at:
                old = {n: cache[n][:, :, t % smax].clone() for n in "kv"}
            steps.append(tmodel.serve_step(
                tp, run_cfg, {"tokens": toks[:, t:t + 1]}, cache, t)[0])
            if t == stale_at:
                for n, a in old.items():
                    cache[n][:, :, t % smax] = a
    dec = torch.cat(steps, 1)
    first = window if stale_at is None else stale_at + 1
    _close(dec[:, :first], full[:, :first], TOL)
    assert float((dec - full).abs().max() / full.abs().max()) > 100 * TOL


def test_windowed_forward_matches_reference():
    jcfg, tcfg = _cfgs("stablelm-3b", compute_dtype="float32",
                       sliding_window=12)
    jp, tp = _params(jcfg, seed=4)
    toks = _tokens(jcfg, 2, 72, seed=9)
    jl, _ = jmodel.forward(jp, jcfg, _batch(toks))
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _batch(toks, torch_side=True))
    _close(tl, jl, TOL)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(11)
    t = rng.standard_normal((3, 1, 2, 16)).astype(np.float32)
    # exact ties: 127 * (k + 1/2) / 127 -> half to even both sides
    t[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    t[1, 0, 1] = 0.0  # an all-zero row: the 1e-8 floor
    jq, js = jattention._quantize_kv(jnp.asarray(t))
    tq, ts = tattention._quantize_kv(torch.from_numpy(t))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq[0, 0, 0, 1:4].numpy()) == [0, 2, -2]


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "gemma-2b"])
def test_int8_kv_cache_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32",
                       kv_cache_quant="int8")
    jp, tp = _params(jcfg, seed=5)
    toks = _tokens(jcfg, 2, 8, seed=12)
    dec, jdec, tcache, jcache = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    assert tcache["k"].dtype == torch.int8
    assert tcache["k_scale"].shape == tcache["k"].shape[:-1]
    _close(dec, jdec, TOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        want = np.asarray(jcache[name])
        got = tcache[name].numpy()
        if name.endswith("scale"):
            # the projections' last bits differ across packages
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    # the reference's bound against the compute-type cache (bf16 compute)
    jcfg, tcfg = _cfgs(arch)
    base = _decode_both(jcfg, tcfg, jp, tp, toks, 16)[0].float()
    q8 = _decode_both(jcfg.replace(kv_cache_quant="int8"),
                      tcfg.replace(kv_cache_quant="int8"), jp, tp, toks,
                      16)[0].float()
    assert float((base - q8).abs().max() / base.abs().max()) < 0.05


def test_hybrid_takes_no_int8_cache():
    _, tcfg = _cfgs("zamba2-2.7b", kv_cache_quant="int8")
    with pytest.raises(TypeError, match="int8"):
        tmodel.init_cache(tcfg, 2, 16, "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_config_for_shape_matches_reference():
    assert tconfigs.FULL_ATTENTION_ARCHS == jconfigs.FULL_ATTENTION_ARCHS
    assert tconfigs.LONG_CONTEXT_SKIP == jconfigs.LONG_CONTEXT_SKIP
    assert tconfigs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW
    for arch in jconfigs.list_archs():
        for shape in jconfigs.SHAPES:
            try:
                want = dataclasses.asdict(jconfigs.config_for_shape(arch,
                                                                    shape))
            except ValueError:
                with pytest.raises(ValueError, match="long_500k"):
                    tconfigs.config_for_shape(arch, shape)
                continue
            assert dataclasses.asdict(
                tconfigs.config_for_shape(arch, shape)) == want
    assert tconfigs.config_for_shape(
        "gemma-2b", "long_500k").sliding_window == 4096
