"""The port's audio family (seamless-m4t-medium, an encoder-decoder over
stub frame embeddings) against the JAX package's, on the smoke config.

The reference's parameters are carried across with
``convert.from_jax_params``, and the same numpy tokens, frame embeddings
and masks go through both packages:

* ``encode_memory`` and ``cross_attention`` at ``Sq == 1`` (the decode
  path) and ``Sq > 1`` (the flash path, a key count a row) with prefix
  masks; the plain ``flash_attention`` with ``valid_len``, non-causal and
  at ``Sq != Sk``; ``kernels.ops.flash_attention``'s ``kv_len`` expansion
  and its ``Sq != Sk`` layout, on CPU tensors;
* ``encode``, ``decode_train``, ``forward``, ``loss_fn`` and its gradient
  in f32 (1e-5 relative; the gradient leaf by leaf, 1e-4 of each leaf's
  largest entry) and in bf16;
* ``prefill`` with a cache, then teacher-forced ``serve_step``, against
  the reference's and against the port's own forward (the reference's
  ``test_decode_matches_forward_encdec``, 1e-4); a non-prefix mask gives
  the same result in the port's prefill and decode (its count is read on
  both paths, ROADMAP C.14);
* Heroes composition, factorized and compose-then-matmul;
* the count helpers (``mlp_flops``, ``param_bytes``, ``linear_out_dim``)
  and ``input_specs`` for every arch and shape;
* the frontends' positions and masks;
* both launchers on the smoke config, the serve launcher's tokens equal to
  a loop of the reference's ``serve_step`` on the same weights, prompts
  and unfilled memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import CompositionConfig as JComp
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import module as jmodule
from repro_torch import configs as tconfigs
from repro_torch.configs.base import CompositionConfig as TComp
from repro_torch.configs.shapes import SHAPES as TSHAPES
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import _flash_math
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_kernel
from repro_torch.launch import specs as tspecs
from repro_torch.models import attention as tattention
from repro_torch.models import encdec as tencdec
from repro_torch.models import frontends as tfrontends
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import module as tmodule
from torch_threads import one_thread  # noqa: F401
from torch_zoo_parity import cfgs as _cfgs
from torch_zoo_parity import close as _close
from torch_zoo_parity import init_tree_matches, launchers_run
from torch_zoo_parity import params as _params
from torch_zoo_parity import tokens as _tokens

ARCH = "seamless-m4t-medium"
TOL = 1e-5   # f32 forward and loss, relative to the reference's
STEP_TOL = 1e-4  # decode against forward (the reference's own test)
GRAD_TOL = 1e-4  # each gradient leaf, relative to its largest entry
# bf16 compute: the packages round activations to bf16 at different
# places (the zoo's tolerance)
BF16_TOL = 6e-2
B, S = 2, 12
VALID = (64, 41)  # valid frames a row: the smoke's encoder_seq, and fewer

_F32 = {}


def _f32():
    """(jcfg, tcfg, reference params, port params), f32 compute, made once
    for the module."""
    if not _F32:
        jcfg, tcfg = _cfgs(ARCH, compute_dtype="float32")
        _F32["v"] = (jcfg, tcfg, *_params(jcfg))
    return _F32["v"]


def _audio(cfg, valid=VALID, seed=0, frames=None):
    """numpy frame embeddings (B, frames, d) and a prefix mask of
    ``valid`` frames a row."""
    n = frames or cfg.encdec.encoder_seq
    rng = np.random.default_rng(100 + seed)
    emb = (0.02 * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return emb, mask


def _batch_np(cfg, toks, seed=0, labels=False, valid=VALID):
    emb, mask = _audio(cfg, valid, seed)
    b = {"tokens": toks, "enc_embeddings": emb, "enc_mask": mask}
    if labels:
        b["labels"] = np.roll(toks, -1, axis=1)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _rel_close(got, want, tol):
    """Within ``tol`` of max(1, max |want|)."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# cross-attention and the flash key counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attention_matches_reference(sq):
    """``encode_memory`` then ``cross_attention`` over a memory of ragged
    valid length: ``Sq == 1`` takes the decode path, ``Sq > 1`` the flash
    path with the mask's counts."""
    jcfg, tcfg, jp, tp = _f32()
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["decoder"])
    tl = tree_map(lambda t: t[0], tp["stack"]["decoder"])
    emb, mask = _audio(jcfg, seed=sq)
    x = (0.3 * np.random.default_rng(sq).standard_normal(
        (B, sq, jcfg.d_model))).astype(np.float32)
    jk, jv = jattention.encode_memory(jl["cross_attn"], jcfg,
                                      jnp.asarray(emb))
    tk, tv = tattention.encode_memory(tl["cross_attn"], tcfg,
                                      torch.from_numpy(emb))
    _close(tk, jk, TOL)
    _close(tv, jv, TOL)
    for m in (mask, None):
        want = jattention.cross_attention(
            jl["cross_attn"], jcfg, jnp.asarray(x), jk, jv,
            None if m is None else jnp.asarray(m))
        with torch.no_grad():
            got = tattention.cross_attention(
                tl["cross_attn"], tcfg, torch.from_numpy(x), tk, tv,
                None if m is None else torch.from_numpy(m))
        assert got.shape == (B, sq, tcfg.d_model)
        _close(got, want, TOL)


@pytest.mark.parametrize("sq,sk,causal", [(5, 40, False), (40, 40, False),
                                          (40, 17, False), (12, 33, True)])
def test_plain_flash_valid_len_matches_reference(sq, sk, causal):
    """The plain chunked softmax with per-row key counts, non-causal and
    at ``Sq != Sk``, against the reference's ``attention.flash_attention``
    (chunks of 8 queries and 16 keys: ragged edges)."""
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, sq, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    vl = np.array([sk, sk // 2 + 1], np.int32)
    kw = dict(causal=causal, q_chunk=8, kv_chunk=16)
    want = jattention.flash_attention(*map(jnp.asarray, (q, k, v)),
                                      valid_len=jnp.asarray(vl), **kw)
    got = tattention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     valid_len=torch.from_numpy(vl), **kw)
    _close(got, want, TOL)


@pytest.mark.parametrize("sq,sk,causal", [(5, 40, False), (40, 17, False),
                                          (12, 33, True), (20, 20, True)])
def test_ops_flash_kv_len_and_layout(sq, sk, causal):
    """``kernels.ops.flash_attention`` on CPU tensors: k and v keep their
    own length (``Sq != Sk``), and ``kv_len`` (B,) is expanded to every KV
    head of its row, as the kernel's (B * KV,) rows; against the plain
    model-layout version and the reference's."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((3, sq, 2, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, sk, 2, 8)).astype(np.float32)
            for _ in range(2))
    vl = np.array([sk, 3, sk // 2 + 1], np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal,
                              kv_len=torch.from_numpy(vl))
    assert got.shape == (3, sq, 2, 2, 8)
    want = tattention.flash_attention(tq, tk, tv, causal=causal,
                                      valid_len=torch.from_numpy(vl))
    _close(got, want.numpy(), TOL)
    _close(got, jattention.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        valid_len=jnp.asarray(vl)), TOL)
    # without kv_len: every key
    _close(ops.flash_attention(tq, tk, tv, causal=causal),
           tattention.flash_attention(tq, tk, tv, causal=causal).numpy(),
           TOL)


def test_flash_kv_len_edges():
    """The kernel wrapper's plain version at the counts the card's phase
    2 holds: 0 (zeros, the kernel's rule), 1, inside a tile, a tile edge
    and every key; each row against the plain softmax over its keys."""
    rng = np.random.default_rng(9)
    BKV, G, Sq, Sk, D = 5, 2, 9, 130, 16
    q = torch.from_numpy(rng.standard_normal((BKV * G, Sq, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((BKV, Sk, D)).astype(
        np.float32)) for _ in range(2))
    counts = torch.tensor([0, 1, 37, 64, Sk], dtype=torch.int32)
    got = flash_kernel(q, k, v, causal=False, q_per_kv=G, kv_len=counts)
    torch.testing.assert_close(got, _flash_math(
        q, k, v, False, 0, G, counts), atol=0, rtol=0)
    assert float(got[:G].abs().max()) == 0.0
    for b in range(1, BKV):
        n = int(counts[b])
        want = _flash_math(q[b * G:(b + 1) * G], k[b:b + 1, :n],
                           v[b:b + 1, :n], False, 0, G)
        torch.testing.assert_close(got[b * G:(b + 1) * G], want,
                                   atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="kv_len"):
        flash_kernel(q, k, v, q_per_kv=G, kv_len=counts[:2])


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def test_encode_and_decode_train_match_reference():
    jcfg, tcfg, jp, tp = _f32()
    b = _batch_np(jcfg, _tokens(jcfg, B, S, seed=1), seed=1)
    enc_pos = jattention.default_positions(B, jcfg.encdec.encoder_seq)
    ecos, esin = jattention.angles_for(jcfg, enc_pos)
    jmem = jencdec.encode(jp["stack"], jcfg, jnp.asarray(b["enc_embeddings"]),
                          jnp.asarray(b["enc_mask"]), ecos, esin)
    tpos = tattention.default_positions(B, tcfg.encdec.encoder_seq)
    tcos, tsin = tattention.angles_for(tcfg, tpos)
    with torch.no_grad():
        tmem = tencdec.encode(tp["stack"], tcfg,
                              torch.from_numpy(b["enc_embeddings"]),
                              torch.from_numpy(b["enc_mask"]), tcos, tsin)
    _rel_close(tmem, jmem, TOL)
    x = (0.3 * np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model))).astype(np.float32)
    cos, sin = jattention.angles_for(jcfg, jattention.default_positions(B, S))
    want = jencdec.decode_train(jp["stack"], jcfg, jnp.asarray(x), jmem,
                                jnp.asarray(b["enc_mask"]), cos, sin)
    cos, sin = tattention.angles_for(tcfg, tattention.default_positions(B, S))
    with torch.no_grad():
        got = tencdec.decode_train(tp["stack"], tcfg, torch.from_numpy(x),
                                   tmem, torch.from_numpy(b["enc_mask"]),
                                   cos, sin)
    _rel_close(got, want, TOL)


def test_forward_and_loss_match_reference():
    jcfg, tcfg, jp, tp = _f32()
    b = _batch_np(jcfg, _tokens(jcfg, B, S), labels=True)
    jl, jaux = jmodel.forward(jp, jcfg, _j(b))
    jloss, _ = jmodel.loss_fn(jp, jcfg, _j(b))
    with torch.no_grad():
        tl, aux = tmodel.forward(tp, tcfg, _t(b))
        loss, met = tmodel.loss_fn(tp, tcfg, _t(b))
    assert tl.shape == (B, S, tcfg.vocab) and float(aux) == float(jaux) == 0
    _rel_close(tl, jl, TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert float(met["ce"]) == float(loss)


def test_bf16_forward_and_loss_match_reference():
    jcfg, tcfg = _cfgs(ARCH)
    assert tcfg.cdtype == torch.bfloat16
    jp, tp = _params(jcfg, seed=3)
    b = _batch_np(jcfg, _tokens(jcfg, B, S, seed=3), seed=3, labels=True)
    jl, _ = jmodel.forward(jp, jcfg, _j(b))
    jloss, _ = jmodel.loss_fn(jp, jcfg, _j(b))
    with torch.no_grad():
        tl, _ = tmodel.forward(tp, tcfg, _t(b))
        loss, _ = tmodel.loss_fn(tp, tcfg, _t(b))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl.astype(jnp.float32), BF16_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_TOL)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_loss_fn_gradients_match_reference():
    """``loss_fn``'s gradient leaf by leaf against ``jax.grad``: the flash
    kernel's plain backward (``kernels.ops``) on the CPU, the encoder's
    non-causal attention and the decoder's cross-attention included."""
    jcfg, tcfg, jp, tp = _f32()
    b = _batch_np(jcfg, _tokens(jcfg, B, S, seed=4), seed=4, labels=True)
    jgrads = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, _j(b))[0])(jp)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss, _ = tmodel.loss_fn(p, tcfg, _t(b))
    loss.backward()
    assert len(leaves) == len(tree_leaves(p))
    for path, want in leaves:
        want = np.asarray(want, np.float32)
        got = _leaf(p, path).grad
        assert got is not None, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=GRAD_TOL,
            atol=GRAD_TOL * float(np.abs(want).max()),
            err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_gradients():
    _, tcfg, _, tp = _f32()
    b = _t(_batch_np(tcfg, _tokens(tcfg, B, 8, seed=5), seed=5,
                     labels=True))
    grads = []
    for remat in (False, True):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
        loss, _ = tmodel.loss_fn(p, tcfg.replace(remat=remat), b)
        loss.backward()
        grads.append([t.grad for t in tree_leaves(p)])
    for a, g in zip(*grads):
        torch.testing.assert_close(a, g, atol=0, rtol=0)


def _steps(tcfg, tp, b, cache):
    out = []
    with torch.no_grad():
        for t in range(b["tokens"].shape[1]):
            lg, cache = tmodel.serve_step(
                tp, tcfg, {"tokens": b["tokens"][:, t:t + 1]}, cache, t)
            out.append(lg)
    return torch.cat(out, 1), cache


def test_prefill_then_serve_steps_match_reference_and_forward():
    jcfg, tcfg, jp, tp = _f32()
    b = _batch_np(jcfg, _tokens(jcfg, B, S, seed=6), seed=6)
    jcache = jmodel.init_cache(jcfg, B, S + 2)
    jpre, jcache = jmodel.prefill(jp, jcfg, _j(b), jcache)
    js = []
    for t in range(S):
        lg, jcache = jmodel.serve_step(
            jp, jcfg, {"tokens": jnp.asarray(b["tokens"][:, t:t + 1])},
            jcache, jnp.int32(t))
        js.append(np.asarray(lg, np.float32))
    tb = _t(b)
    tcache = tmodel.init_cache(tcfg, B, S + 2, "cpu")
    assert tcache["mem_k"].shape == (tcfg.num_layers, B,
                                     tcfg.encdec.encoder_seq, 4, 32)
    with torch.no_grad():
        tpre, c2 = tmodel.prefill(tp, tcfg, tb, tcache)
        full, _ = tmodel.forward(tp, tcfg, tb)
    assert c2 is tcache
    np.testing.assert_array_equal(tcache["mem_mask"].numpy(), b["enc_mask"])
    _rel_close(tcache["mem_k"], jcache["mem_k"], TOL)
    _rel_close(tpre, jpre, TOL)
    dec, _ = _steps(tcfg, tp, tb, tcache)
    _close(dec, np.concatenate(js, 1), STEP_TOL)
    _close(dec, full.numpy(), STEP_TOL)


def test_prefill_memory_fills_the_leading_rows():
    """A memory shorter than ``encoder_seq``: its K/V fill the cache's
    leading rows and the rest stay masked, so the steps equal those over
    the reference's (shorter) replaced arrays."""
    jcfg, tcfg, jp, tp = _f32()
    toks = _tokens(jcfg, B, 6, seed=7)
    emb, mask = _audio(jcfg, valid=(20, 13), seed=7, frames=24)
    b = {"tokens": toks, "enc_embeddings": emb, "enc_mask": mask}
    jcache = jmodel.init_cache(jcfg, B, 8)
    _, jcache = jmodel.prefill(jp, jcfg, _j(b), jcache)
    js = []
    for t in range(6):
        lg, jcache = jmodel.serve_step(
            jp, jcfg, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache,
            jnp.int32(t))
        js.append(np.asarray(lg, np.float32))
    tcache = tmodel.init_cache(tcfg, B, 8, "cpu")
    with torch.no_grad():
        tmodel.prefill(tp, tcfg, _t(b), tcache)
    assert int(tcache["mem_mask"].sum()) == 33
    assert float(tcache["mem_k"][:, :, 24:].abs().max()) == 0.0
    dec, _ = _steps(tcfg, tp, _t(b), tcache)
    _close(dec, np.concatenate(js, 1), STEP_TOL)
    with pytest.raises(ValueError, match="frames"):
        tencdec.prefill_memory(tp["stack"], tcfg, torch.zeros(
            B, 65, tcfg.d_model), torch.ones(B, 65, dtype=torch.bool),
            tcache)


def test_non_prefix_mask_prefill_and_decode_agree():
    """The port reads a memory mask as its count of valid frames on every
    path (ROADMAP C.14): with a mask that is not a prefix, prefill's
    flash path and decode's path agree, and both equal the prefix mask
    of the same counts."""
    _, tcfg, _, tp = _f32()
    b = _batch_np(tcfg, _tokens(tcfg, B, 8, seed=8), seed=8)
    rng = np.random.default_rng(8)
    scattered = np.stack([rng.permutation(row) for row in b["enc_mask"]])
    assert (scattered != b["enc_mask"]).any()
    outs = []
    for m in (scattered, b["enc_mask"]):
        tb = _t(dict(b, enc_mask=m))
        cache = tmodel.init_cache(tcfg, B, 8, "cpu")
        with torch.no_grad():
            pre, _ = tmodel.prefill(tp, tcfg, tb, cache)
        dec, _ = _steps(tcfg, tp, tb, cache)
        _close(dec, pre.numpy(), STEP_TOL)
        outs.append(dec)
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


@pytest.fixture
def compose_flag():
    """Sets both packages' compose-then-matmul switch from the test and
    resets them after it."""
    def set_both(on):
        jmodule.set_compose_then_matmul(on)
        tmodule.set_compose_then_matmul(on)
    yield set_both
    set_both(False)


@pytest.mark.parametrize("then_matmul", [False, True])
@pytest.mark.parametrize("max_width", [1, 2])
def test_composition_matches_reference(max_width, then_matmul, compose_flag):
    """Heroes composition on, at full width p = P (the reference's
    factorized linear takes d_model-wide inputs only there): the
    factorized forward, and the paper's compose-then-matmul, which in the
    port composes through the compose wrapper (its plain version on the
    CPU)."""
    compose_flag(then_matmul)
    jcfg, tcfg = _cfgs(ARCH, compute_dtype="float32",
                       composition=JComp(enabled=True, max_width=max_width))
    tcfg = tcfg.replace(composition=TComp(enabled=True, max_width=max_width))
    jp, tp = _params(jcfg, seed=max_width)
    assert "basis" in tp["stack"]["decoder"]["cross_attn"]["wq"]
    b = _batch_np(jcfg, _tokens(jcfg, B, 8, seed=max_width),
                  seed=max_width, labels=True)
    jl, _ = jmodel.forward(jp, jcfg, _j(b))
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    tl, _ = tmodel.forward(p, tcfg, _t(b))
    _rel_close(tl.detach(), jl, TOL)
    tl.float().square().mean().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tree_leaves(p))


def test_compose_then_matmul_equals_factorized():
    """One factorized linear both ways, against the reference's
    ``compose_then_matmul`` branch, at widths 1-3."""
    rng = np.random.default_rng(11)
    for p in (1, 2, 3):
        basis = rng.standard_normal((8, 4)).astype(np.float32)
        coeff = rng.standard_normal((p * p, 4, 6)).astype(np.float32)
        x = rng.standard_normal((3, 5, p * 8)).astype(np.float32)
        tparams = {"basis": torch.from_numpy(basis),
                   "coeff": torch.from_numpy(coeff)}
        jparams = {"basis": jnp.asarray(basis), "coeff": jnp.asarray(coeff)}
        fact = tmodule.linear(tparams, torch.from_numpy(x))
        try:
            jmodule.set_compose_then_matmul(True)
            tmodule.set_compose_then_matmul(True)
            got = tmodule.linear(tparams, torch.from_numpy(x))
            want = jmodule.linear(jparams, jnp.asarray(x))
        finally:
            jmodule.set_compose_then_matmul(False)
            tmodule.set_compose_then_matmul(False)
        _close(got, want, TOL)
        _close(got, fact.numpy(), TOL)
        w = tmodule.composed_weight(tparams["basis"], tparams["coeff"], p)
        assert w.shape == (p * 8, p * 6)


# ---------------------------------------------------------------------------
# the count helpers and the input specs
# ---------------------------------------------------------------------------


def test_count_helpers_match_reference():
    for act in ("gelu", "swiglu", "geglu"):
        assert tlayers.mlp_flops(1024, 4096, act, 512) == \
            jlayers.mlp_flops(1024, 4096, act, 512)
    jcfg, tcfg, jp, tp = _f32()
    assert tmodule.param_bytes(tp) == jmodule.param_bytes(jp)
    assert tmodule.count_params(tp) == jmodule.count_params(jp)
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tbf = from_jax_params(jax.device_get(jbf), "cpu")  # bf16 params
    assert tmodule.param_bytes(tbf) == jmodule.param_bytes(jbf) == \
        jmodule.param_bytes(jp) // 2
    lin = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["stack"]["decoder"]["mlp"]["up"])
    tlin = tree_map(lambda t: t[0], tp["stack"]["decoder"]["mlp"]["up"])
    assert tmodule.linear_out_dim(tlin) == jmodule.linear_out_dim(lin) == \
        tcfg.d_ff
    jc, tc = _cfgs(ARCH, composition=JComp(enabled=True, max_width=2))
    tc = tc.replace(composition=TComp(enabled=True, max_width=2))
    jpc, tpc = _params(jc)
    lin = jax.tree_util.tree_map(lambda a: a[0],
                                 jpc["stack"]["encoder"]["mlp"]["down"])
    tlin = tree_map(lambda t: t[0], tpc["stack"]["encoder"]["mlp"]["down"])
    for width in (0, 1, 2):
        assert tmodule.linear_out_dim(tlin, width) == \
            jmodule.linear_out_dim(lin, width)


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + (k,))
    else:
        yield pre, tree


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_input_specs_match_reference(arch, shape):
    """Every leaf's shape and type against the reference's
    ``ShapeDtypeStruct``; the port's are ``meta`` tensors (never
    allocated)."""
    want = dict(_flat(jspecs.input_specs(jconfigs.get_config(arch),
                                         JSHAPES[shape])))
    got = dict(_flat(tspecs.input_specs(tconfigs.get_config(arch),
                                        TSHAPES[shape])))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[1] == str(w.dtype), k


# ---------------------------------------------------------------------------
# frontends, init, launchers
# ---------------------------------------------------------------------------


def test_frontends_positions_and_masks_match_reference():
    for n, grid in ((12, None), (12, (2, 6)), (7, None)):
        want = jfrontends.vision_patch_embeddings(
            jax.random.PRNGKey(0), 2, n, 16, grid)
        got = tfrontends.vision_patch_embeddings(
            torch.Generator().manual_seed(0), 2, n, 16, grid)
        assert got["embeddings"].shape == want["embeddings"].shape
        np.testing.assert_array_equal(got["positions"].numpy(),
                                      np.asarray(want["positions"]))
        table = np.random.default_rng(n).standard_normal((30, 16)).astype(
            np.float32)
        toks = _tokens(tconfigs.get_smoke(ARCH).replace(vocab=30), 2, 5)
        jw = jfrontends.interleave_text(None, want, jnp.asarray(toks),
                                        jnp.asarray(table))
        tw = tfrontends.interleave_text(got, torch.from_numpy(toks),
                                        torch.from_numpy(table))
        np.testing.assert_array_equal(tw["positions"].numpy(),
                                      np.asarray(jw["positions"]))
        np.testing.assert_array_equal(tw["embeddings"][:, n:].numpy(),
                                      np.asarray(jw["embeddings"])[:, n:])
    for valid in (None, np.array([5, 0, 9], np.int32)):
        want = jfrontends.audio_frame_embeddings(
            jax.random.PRNGKey(1), 3, 9, 8,
            None if valid is None else jnp.asarray(valid))
        got = tfrontends.audio_frame_embeddings(
            torch.Generator().manual_seed(1), 3, 9, 8,
            None if valid is None else torch.from_numpy(valid))
        assert got["enc_embeddings"].shape == (3, 9, 8)
        assert 0.005 < float(got["enc_embeddings"].std()) < 0.05
        np.testing.assert_array_equal(got["enc_mask"].numpy(),
                                      np.asarray(want["enc_mask"]))


def test_init_matches_reference_tree():
    tp = init_tree_matches(*_cfgs(ARCH))
    cache = tmodel.init_cache(tconfigs.get_smoke(ARCH), 2, 8, "cpu")
    assert sorted(cache) == ["mem_k", "mem_mask", "mem_v", "self"]


def test_launchers_serve_and_train(capsys):
    out = launchers_run(ARCH, capsys)
    assert "stub frontends" in out


def test_serve_launcher_tokens_match_reference_loop():
    """``launch/serve.py``'s loop on the reference's weights (f32 compute)
    against the reference's own loop, re-run here with ``serve_step``: the
    same prompts, the same zero frames and an unfilled memory (neither
    loop prefills it), greedy tokens equal."""
    from repro_torch.launch import serve as tserve

    jcfg, tcfg, jp, tp = _f32()
    kw = dict(requests=3, batch=2, max_new=4, max_len=24)
    r = tserve.serve(tcfg, tp, device="cpu", **kw)
    assert r["done"] == 3
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, jcfg.vocab, rng.integers(4, 12)).tolist()
             for _ in range(kw["requests"])]
    Bs = kw["batch"]
    cache = jmodel.init_cache(jcfg, Bs, kw["max_len"])
    step = jax.jit(lambda p, b, c, n: jmodel.serve_step(p, jcfg, b, c, n))
    active, outputs = [None] * Bs, {}
    next_req = done = pos = 0
    cur = np.zeros((Bs, 1), np.int32)
    se = min(jcfg.encdec.encoder_seq, 32)
    while done < kw["requests"] and pos < kw["max_len"] - 1:
        for s in range(Bs):
            if active[s] is None and next_req < len(queue):
                active[s] = [next_req, list(queue[next_req]), 0]
                outputs[next_req] = []
                next_req += 1
        batch = {"tokens": jnp.asarray(cur),
                 "enc_embeddings": jnp.zeros((Bs, se, jcfg.d_model)),
                 "enc_mask": jnp.ones((Bs, se), bool)}
        logits, cache = step(jp, batch, cache, jnp.int32(pos))
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1))
        for s in range(Bs):
            if active[s] is None:
                continue
            rid, prompt, _ = active[s]
            if prompt:
                cur[s, 0] = prompt.pop(0)
            else:
                cur[s, 0] = nxt[s]
                outputs[rid].append(int(nxt[s]))
                active[s][2] += 1
                if active[s][2] >= kw["max_new"]:
                    done += 1
                    active[s] = None
        pos += 1
    assert r["outputs"] == outputs
