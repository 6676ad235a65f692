"""The port's model zoo (hybrid family, zamba2) against the JAX package's.

The reference's parameters (``repro.models.model.init`` on the zamba2
smoke config) are carried across with ``convert.from_jax_params``, and
the same numpy tokens go through both packages:

* ``model.forward`` logits at T = 80 (three 32-token chunks, the last
  padded) within atol/rtol 1e-4 in f32, and ``loss_fn``;
* ``loss_fn``'s gradient (``backward``) against ``jax.grad`` of the
  reference's, leaf by leaf: the zoo's kernels run forward, and their
  backward is their plain versions' (``kernels.ops``); the kernel
  wrappers themselves still refuse autograd;
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
* ``launch.serve --arch zamba2-2.7b --smoke --device cpu`` serves every
  request;
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
from repro_torch.core.estimator import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import module as tmodule
from repro_torch.models import sampling as tsampling

ARCH = "zamba2-2.7b"
TOL = 1e-4
# bf16 compute: the two packages round activations to bf16 at different
# places (the port's CPU attention keeps f32 scores and sums; the
# reference's casts p to bf16 before p @ v), so logits of magnitude ~4
# agree to about 2-3 bf16 ulps after the two layers
BF16_TOL = 6e-2
# gradients in f32, each leaf relative to its own largest entry (the
# leaves span 4e-5 (A_log) to 0.2 (conv_w)); seen up to 2.6e-6
GRAD_TOL = 1e-4


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


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_loss_fn_gradients_match_reference(f32):
    jcfg, tcfg, jp, tp = f32
    toks = _tokens(jcfg, 2, 80, seed=4)
    labels = np.roll(toks, -1, axis=1)
    jgrads = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0])(jp)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tp = tmodule.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss, _ = tmodel.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    loss.backward()
    assert len(leaves) == len(tmodule.tree_leaves(tp)) == 21
    for path, want in leaves:
        want = np.asarray(want)
        got = _leaf(tp, path).grad
        assert got is not None, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(want).max()),
            err_msg=jax.tree_util.keystr(path))


def test_kernel_wrappers_refuse_autograd():
    """The kernel wrappers stay forward-only, as the reference's
    ``pallas_call`` is: called directly under autograd they raise; under
    ``no_grad`` they return."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g).requires_grad_()

    calls = {
        "rmsnorm": lambda: rmsnorm(rn(4, 16), rn(16)),
        "ssd_chunk": lambda: ssd_chunk(
            rn(2, 8, 4), rn(2, 8, 4), rn(2, 8, 4), torch.zeros(2, 8),
            rn(2, 4, 4)),
        "flash_attention": lambda: flash_attention(
            rn(2, 8, 4), rn(1, 8, 4), rn(1, 8, 4), q_per_kv=2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()


def _oracle_cases():
    """(op, its oracle, inputs, which require grad), f64 on the CPU: the
    ops in the model layout against the port's oracles (``kernels.ref``;
    attention against the zoo's plain chunked softmax)."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import flash_attention as chunked

    g = torch.Generator().manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    return {
        "rmsnorm": (lambda x, s: ops.rmsnorm(x, s),
                    lambda x, s: ref.rmsnorm_ref(x, s),
                    (rn(3, 5, 16), rn(16)), (True, True)),
        # h_in without a gradient: that input's slot is None
        "ssd_chunk": (ops.ssd_chunk, ref.ssd_chunk_ref,
                      (rn(4, 8, 4), rn(4, 8, 4), rn(4, 8, 6),
                       -rn(4, 8).abs().cumsum(-1), rn(4, 4, 6)),
                      (True, True, True, True, False)),
        "flash_attention": (
            ops.flash_attention,
            lambda q, k, v: chunked(q, k, v, q_chunk=4, kv_chunk=4),
            (rn(2, 10, 2, 3, 8), rn(2, 10, 2, 8), rn(2, 10, 2, 8)),
            (True, True, True)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "ssd_chunk", "flash_attention"])
def test_ops_gradients_match_oracles(name):
    """The three ops the zoo trains through take the gradient of their
    plain version (recomputed in the backward) wherever they run: held
    to autograd through an independent oracle.  The plain versions
    compute in f32, hence the tolerance."""
    op, oracle, inputs, need = _oracle_cases()[name]
    grads = []
    for fn in (op, oracle):
        xs = [t.clone().requires_grad_(n) for t, n in zip(inputs, need)]
        out = fn(*xs)
        w = torch.linspace(-1, 1, out.numel(), dtype=out.dtype)
        (out * w.reshape(out.shape)).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want, n in zip(*grads, need):
        assert (got is None) == (not n)
        if n:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_zoo_routes_to_the_kernels_unless_recording(f32, monkeypatch):
    """The zoo reaches the kernel wrappers (through ``kernels.ops``)
    under ``no_grad`` and while a gradient is recorded alike, so serving
    and training both launch the kernels on the card; training's
    backward is the plain versions'."""
    _, tcfg, _, tp = f32
    seen = []
    for name in ("rmsnorm_kernel", "ssd_chunk_kernel"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **k: (
            seen.append(_n), _f(*a, **k))[1])
    toks = torch.from_numpy(_tokens(tcfg, 1, 40, seed=5))
    with torch.no_grad():
        tmodel.forward(tp, tcfg, {"tokens": toks})
    assert set(seen) == {"rmsnorm_kernel", "ssd_chunk_kernel"}
    seen.clear()
    tp = tmodule.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    logits, _ = tmodel.forward(tp, tcfg, {"tokens": toks})
    logits.float().sum().backward()
    assert set(seen) == {"rmsnorm_kernel", "ssd_chunk_kernel"}
    assert all(t.grad is not None for t in tmodule.tree_leaves(tp))


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
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
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


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_every_arch_inits(arch):
    """Every family is ported: each arch's smoke config inits on the CPU,
    and so does its cache (the families' parity tests are
    ``tests/test_torch_{zoo,dense,moe,xlstm,mrope,encdec}.py``)."""
    cfg = tconfigs.get_smoke(arch)
    params = tmodel.init(0, cfg, "cpu")
    assert tmodule.count_params(params) > 0
    assert all(t.device.type == "cpu"
               for t in tree_leaves(tmodel.init_cache(cfg, 2, 8, "cpu")))


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
