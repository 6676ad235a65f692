"""The port's model zoo (hybrid family, zamba2) against the JAX package's.

The reference's parameters (``repro.models.model.init`` on the zamba2
smoke config) are carried across with ``convert.from_jax_params``, and
the same numpy tokens go through both packages:

* ``model.forward`` logits at T = 80 (three 32-token chunks, the last
  padded) within atol/rtol 1e-4 in f32, and ``loss_fn``;
* 12 teacher-forced ``serve_step`` logits within 1e-4, and the port's
  own forward against its step-by-step decode (the reference's
  ``tests/test_decode_consistency.py`` check);
* Heroes composition on (``composition.enabled``) at max widths 1 and 2,
  each at its full width p = P — the reference's factorized linear
  takes d_model-wide inputs only at p = P;
* compute in bf16 (f32 params), with a bf16 tolerance;
* ``sample_logits``: greedy equals the reference's argmax, and the
  top-k / top-p filters keep the token sets the reference samples from.
  Random draws differ across frameworks by construction (a
  ``torch.Generator`` against ``jax.random``), so draws are compared as
  sets, not one by one;
* ``launch.serve --smoke --device cpu`` serves every request;
* the configs are the reference's, number for number.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import CompositionConfig as JComp
from repro.models import model as jmodel
from repro.models import sampling as jsampling
from repro_torch import configs as tconfigs
from repro_torch.configs.base import CompositionConfig as TComp
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import sampling as tsampling

ARCH = "zamba2-2.7b"
TOL = 1e-4
# bf16 compute: the two packages round activations to bf16 at different
# places (the port's CPU attention keeps f32 scores and sums; the
# reference's casts p to bf16 before p @ v), so logits of magnitude ~4
# agree to about 2-3 bf16 ulps after the two layers
BF16_TOL = 6e-2


def _cfgs(**kw):
    return (jconfigs.get_smoke(ARCH).replace(**kw),
            tconfigs.get_smoke(ARCH).replace(**kw))


def _params(jcfg, seed=0):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.device_get(jp), "cpu")


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    jp, tp = _params(jcfg)
    return jcfg, tcfg, jp, tp


def test_forward_and_loss_match_reference(f32):
    jcfg, tcfg, jp, tp = f32
    toks = _tokens(jcfg, 2, 80)
    labels = np.roll(toks, -1, axis=1)
    jl, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, aux = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        loss, met = tmodel.loss_fn(tp, tcfg, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)})
    assert tl.shape == (2, 80, tcfg.vocab) and float(aux) == 0.0
    _close(tl, jl, TOL)
    jloss, _ = jmodel.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert float(met["ce"]) == float(loss)


def test_serve_steps_match_reference_and_forward(f32):
    jcfg, tcfg, jp, tp = f32
    B, S = 2, 12
    toks = _tokens(jcfg, B, S, seed=1)
    jstep = jax.jit(lambda p, b, c, n: jmodel.serve_step(p, jcfg, b, c, n))
    jcache = jmodel.init_cache(jcfg, B, S + 2)
    tcache = tmodel.init_cache(tcfg, B, S + 2, "cpu")
    jsteps, tsteps = [], []
    with torch.no_grad():
        for t in range(S):
            jl, jcache = jstep(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jcache, jnp.int32(t))
            tl, tcache = tmodel.serve_step(
                tp, tcfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                tcache, t)
            jsteps.append(np.asarray(jl))
            tsteps.append(tl)
        full, _ = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    dec = torch.cat(tsteps, dim=1)
    _close(dec, np.concatenate(jsteps, axis=1), TOL)
    _close(dec, full.numpy(), TOL)


def test_prefill_returns_forward_logits_and_the_cache(f32):
    _, tcfg, _, tp = f32
    toks = torch.from_numpy(_tokens(tcfg, 2, 40))
    cache = tmodel.init_cache(tcfg, 2, 48, "cpu")
    with torch.no_grad():
        lg, c2 = tmodel.prefill(tp, tcfg, {"tokens": toks}, cache)
        full, _ = tmodel.forward(tp, tcfg, {"tokens": toks})
    assert c2 is cache
    torch.testing.assert_close(lg, full, atol=0, rtol=0)


@pytest.mark.parametrize("max_width", [1, 2])
def test_composed_forward_matches_reference(max_width):
    kw = dict(compute_dtype="float32")
    jcfg, tcfg = _cfgs(composition=JComp(enabled=True, max_width=max_width),
                       **kw)
    tcfg = tcfg.replace(composition=TComp(enabled=True, max_width=max_width))
    jp, tp = _params(jcfg, seed=max_width)
    assert "basis" in tp["stack"]["mamba"]["in_proj"]
    toks = _tokens(jcfg, 2, 40, seed=max_width)
    jl, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, TOL)
    init = tmodel.init(0, tcfg, "cpu")
    assert {k: tuple(v.shape) for k, v in init["stack"]["mamba"][
        "in_proj"].items()} == {k: tuple(v.shape) for k, v in tp["stack"][
            "mamba"]["in_proj"].items()}


def test_bf16_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    assert tcfg.cdtype == torch.bfloat16
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, 2, 40, seed=3)
    jl, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    _close(tl, jl.astype(jnp.float32), BF16_TOL)


def test_init_matches_reference_tree():
    jcfg, tcfg = _cfgs()
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                    jax.eval_shape(lambda: jmodel.init(
                                        jax.random.PRNGKey(0), jcfg)))
    tp = tmodel.init(0, tcfg, "cpu")

    def walk(j, t):
        if isinstance(j, dict):
            assert sorted(j) == sorted(t)
            for k in j:
                walk(j[k], t[k])
        else:
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == j

    walk(shapes, tp)


def test_sample_logits_greedy_and_filters_match_reference():
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((3, 12))).astype(np.float32)
    tl = torch.from_numpy(logits)
    greedy = tsampling.sample_logits(None, tl, temperature=0.0)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(
        jsampling.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits),
                                temperature=0.0)))
    n = 4000
    rep = np.repeat(logits, n, axis=0)
    for kw in (dict(top_k=4), dict(top_p=0.6), dict(top_k=6, top_p=0.7)):
        kept = torch.isfinite(tsampling.filter_logits(tl, temperature=0.8,
                                                      **kw)).numpy()
        jdraw = np.asarray(jsampling.sample_logits(
            jax.random.PRNGKey(1), jnp.asarray(rep), temperature=0.8,
            **kw)).reshape(3, n)
        gen = torch.Generator().manual_seed(1)
        tdraw = tsampling.sample_logits(gen, torch.from_numpy(rep),
                                        temperature=0.8,
                                        **kw).numpy().reshape(3, n)
        for b in range(3):
            want = set(np.flatnonzero(kept[b]).tolist())
            assert set(jdraw[b].tolist()) == want, kw
            assert set(tdraw[b].tolist()) == want, kw


def test_perplexity_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = tsampling.perplexity(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        want = jsampling.perplexity(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_serve_launcher_serves_every_request(capsys):
    tserve.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("served 8/8 requests, 128 tokens"), out


def test_serve_loop_greedy_outputs_match_forward(f32):
    """The loop's greedy tokens are the forward's argmax along each
    served slot's sequence (one request per slot, no refill)."""
    _, tcfg, _, tp = f32
    r = tserve.serve(tcfg, tp, requests=2, batch=2, max_new=5, max_len=24,
                     device="cpu")
    assert r["done"] == 2 and r["tokens"] == 10
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, rng.integers(4, 12)).tolist()
               for _ in range(2)]
    for rid, prompt in enumerate(prompts):
        seq = list(prompt)
        for _ in range(5):
            with torch.no_grad():
                lg, _ = tmodel.forward(tp, tcfg, {
                    "tokens": torch.tensor([[0] + seq])})
            seq.append(int(lg[0, -1].argmax()))
        assert r["outputs"][rid] == seq[len(prompt):]


def test_other_families_raise():
    cfg = tconfigs.get_smoke("gemma-2b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.init(0, cfg, "cpu")


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_match_reference(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for get in ("get_config", "get_smoke"):
        j = getattr(jconfigs, get)(arch)
        t = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert str(t.pdtype).split(".")[1] == str(j.pdtype)
        assert str(t.cdtype).split(".")[1] == str(j.cdtype)
        assert t.param_count() == j.param_count()
