"""The port's attention against the JAX package's, on the same inputs.

* The decode- and flash-attention wrappers (on the CPU: the kernels'
  plain versions) and the model-layout ``kernels.ops`` wrappers against
  the reference's Pallas kernels in interpret mode and its oracles in
  ``repro.kernels.ref``, over the reference's sweep shapes in f32 and
  bf16.  f32 is held to ``tests/test_kernels.py``'s tolerance (8x 2e-5,
  relative and absolute).  In bf16 the plain versions round p to v's
  type as the Pallas kernels do, so they are held to those kernels at
  atol 1e-3, rtol 1e-2 (rtol: one bf16 ulp of the output; worst atol
  needed at that rtol, 2.4e-4, where the Pallas kernel's running max
  differs from the row's), and to the f32 oracles, which do not round p,
  at atol 4e-3 (worst needed 1.7e-3).
* The plain versions round p exactly as the reference (a case the
  unrounded softmax fails), the kernel's split-and-merge arithmetic
  equals the unsplit plain version, and ``kernels.ops.decode_attention``
  hands the model-layout caches to the kernel uncopied.
* ``models.attention.flash_attention`` (the differentiable training path)
  against the reference's scan, with chunks small enough that several
  blocks stream; RoPE against the reference's.
* The two kernels refuse to record a gradient (the reference's
  ``pallas_call`` has none); ``ssd_chunk`` and ``rmsnorm``, once
  unported, now return results.

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same normal draws as a jax array and a torch tensor of
    ``dtype`` (both round f32 to bf16 to nearest even)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


# bf16 (atol, rtol) against the reference's Pallas kernels and against
# its f32 oracles (see the module docstring)
BF16_TOL = {"kernel": (1e-3, 1e-2), "oracle": (4e-3, 1e-2)}


def _close(got, want, dtype, against="kernel"):
    atol, rtol = ((8 * TOL[dtype],) * 2 if dtype == "float32"
                  else BF16_TOL[against])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


FLASH_SWEEP = [
    (1, 64, 1, 1, 32, 0),     # MHA degenerate
    (2, 100, 2, 3, 32, 0),    # GQA, ragged seq
    (1, 128, 4, 1, 64, 32),   # sliding window
    (2, 33, 1, 4, 16, 8),     # MQA + tiny window + ragged
]
DECODE_SWEEP = [
    (2, 64, 2, 2, 32),
    (1, 500, 1, 8, 64),   # MQA long ragged cache
    (4, 33, 4, 1, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,kv,g,d,window", FLASH_SWEEP)
def test_ops_flash_attention_matches_reference(dtype, b, s, kv, g, d,
                                               window):
    rng = np.random.default_rng(s * 7 + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, s, kv, g, d), dtype),
                                    _pair(rng, (b, s, kv, d), dtype),
                                    _pair(rng, (b, s, kv, d), dtype))
    got = tops.flash_attention(tq, tk, tv, window=window)
    assert got.shape == (b, s, kv, g, d) and got.dtype == TDT[dtype]
    _close(got, jops.flash_attention(jq, jk, jv, window=window,
                                     interpret=True), dtype)
    # the oracle on repeated K/V, in f32
    qf = jnp.transpose(jq, (0, 2, 3, 1, 4)).reshape(b * kv * g, s, d)
    kf = jnp.repeat(jnp.transpose(jk, (0, 2, 1, 3)).reshape(b * kv, s, d),
                    g, 0)
    vf = jnp.repeat(jnp.transpose(jv, (0, 2, 1, 3)).reshape(b * kv, s, d),
                    g, 0)
    want = jref.attention_ref(qf.astype(jnp.float32), kf.astype(jnp.float32),
                              vf.astype(jnp.float32), window=window)
    _close(got, jnp.transpose(want.reshape(b, kv, g, s, d), (0, 3, 1, 2, 4)),
           dtype, "oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,kv,g,d", DECODE_SWEEP)
def test_ops_decode_attention_matches_reference(dtype, b, s, kv, g, d):
    rng = np.random.default_rng(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, 1, kv, g, d), dtype),
                                    _pair(rng, (b, s, kv, d), dtype),
                                    _pair(rng, (b, s, kv, d), dtype))
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == (b, 1, kv, g, d) and got.dtype == TDT[dtype]
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                      interpret=True), dtype)
    qf = jq[:, 0].reshape(b * kv * g, d)
    kf = jnp.repeat(jnp.transpose(jk, (0, 2, 1, 3)).reshape(b * kv, s, d),
                    g, 0)
    vf = jnp.repeat(jnp.transpose(jv, (0, 2, 1, 3)).reshape(b * kv, s, d),
                    g, 0)
    want = jref.decode_attention_ref(
        qf.astype(jnp.float32), kf.astype(jnp.float32),
        vf.astype(jnp.float32), jnp.repeat(jnp.asarray(lens), kv * g))
    _close(got, want.reshape(b, 1, kv, g, d), dtype, "oracle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bkv,g,sq,sk,d,causal,window", [
    (2, 1, 70, 130, 32, True, 0),   # queries aligned to the end of keys
    (1, 2, 64, 64, 80, False, 0),   # non-causal, GQA
    (1, 1, 50, 50, 16, False, 16),  # non-causal sliding window
    (1, 3, 9, 300, 8, True, 100),   # long window over a long key row
])
def test_flash_kernel_layout_matches_pallas(dtype, bkv, g, sq, sk, d, causal,
                                            window):
    rng = np.random.default_rng(sq * 31 + sk)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (bkv * g, sq, d), dtype),
                                    _pair(rng, (bkv, sk, d), dtype),
                                    _pair(rng, (bkv, sk, d), dtype))
    got = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_per_kv=g)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  q_per_kv=g, interpret=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bkv,g,s,d", [(3, 1, 40, 8), (2, 4, 600, 64),
                                       (1, 2, 17, 256)])
def test_decode_kernel_layout_matches_pallas(dtype, bkv, g, s, d):
    """Raw kernel layout (BH, D) x (BKV, S, D), more than one 512-wide KV
    block of the TPU kernel, head_dim up to the CUDA kernel's 256."""
    rng = np.random.default_rng(s * 3 + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (bkv * g, d), dtype),
                                    _pair(rng, (bkv, s, d), dtype),
                                    _pair(rng, (bkv, s, d), dtype))
    lens = rng.integers(1, s + 1, bkv * g).astype(np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens), q_per_kv=g)
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens), q_per_kv=g,
                                   interpret=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("g", [1, 4, 8])
def test_ops_decode_attention_reads_model_layout_uncopied(monkeypatch, g):
    """``kernels.ops.decode_attention`` passes the (B, S, KV, D) caches to
    the kernel wrapper as they are (the kernel reads the model layout),
    and equals the reference's ``ops.decode_attention``."""
    from repro_torch.kernels import ops as tops_mod

    b, s, kv, d = 3, 700, 2, 32
    rng = np.random.default_rng(g)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (b, 1, kv, g, d), "bfloat16"),
                                    _pair(rng, (b, s, kv, d), "bfloat16"),
                                    _pair(rng, (b, s, kv, d), "bfloat16"))
    lens = np.array([s, 1, 413], np.int32)
    seen = []
    kernel = tops_mod.decode_attention_kernel

    def spy(q, k, v, lengths, **kw):
        seen.append((k, v))
        return kernel(q, k, v, lengths, **kw)

    monkeypatch.setattr(tops_mod, "decode_attention_kernel", spy)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert len(seen) == 1 and seen[0][0] is tk and seen[0][1] is tv
    assert got.shape == (b, 1, kv, g, d)
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                      interpret=True), "bfloat16")


def _frac_differing(got, want):
    return float(np.mean(got.float().numpy() != np.asarray(want, np.float32)))


@pytest.mark.parametrize("which", ["flash", "decode"])
def test_plain_versions_round_p_as_the_reference(which):
    """With one KV block (the Pallas kernel's running max is the row's
    max) the bf16 plain version gives the Pallas kernel's bf16 outputs,
    but for rare last-bit flips of the f32 sums' order.  The same softmax
    without rounding p (the f32 plain version on the same values) misses
    a third of them: removing the cast fails this case."""
    rng = np.random.default_rng(7)
    if which == "flash":
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (4, 64, 32), "bfloat16")
                                        for _ in range(3))
        want = flash_attention_pallas(jq, jk, jv, interpret=True)
        got = flash_attention(tq, tk, tv)
        unrounded = flash_attention(tq.float(), tk.float(), tv.float())
    else:
        jq, tq = _pair(rng, (8, 64), "bfloat16")
        (jk, tk), (jv, tv) = (_pair(rng, (2, 300, 64), "bfloat16")
                              for _ in range(2))
        lens = rng.integers(1, 301, 8).astype(np.int32)
        want = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                       q_per_kv=4, interpret=True)
        got = decode_attention(tq, tk, tv, torch.from_numpy(lens), q_per_kv=4)
        unrounded = decode_attention(tq.float(), tk.float(), tv.float(),
                                     torch.from_numpy(lens), q_per_kv=4)
    assert _frac_differing(got, want) <= 0.01
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               atol=2e-3, rtol=2 ** -7)
    assert _frac_differing(unrounded.to(torch.bfloat16), want) >= 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_merge_matches_unsplit(dtype, splits):
    """The kernel's split arithmetic (each split's (m, l, acc), merged in
    split order) equals the unsplit plain version; the last split is
    ragged and some rows end before it, one row is empty.  In bf16 each
    split rounds p against its own max, so the two differ by that
    rounding (the attention kernels' bf16 tolerance)."""
    from repro_torch.kernels.decode_attention import _decode_math, _split_math

    rng = np.random.default_rng(splits)
    S, D, G = 1300, 32, 4
    _, q = _pair(rng, (3 * G, D), dtype)
    _, k = _pair(rng, (3, S, D), dtype)
    _, v = _pair(rng, (3, S, D), dtype)
    lens = torch.tensor([0, S, 1299, 17, 500, 1, 256, 257, 1200, S, 3, 700])
    chunk = 64 * -(-S // (64 * splits))  # whole 64-key tiles, as planned
    assert -(-S // chunk) == splits
    got = _split_math(q, k, v, lens, G, splits, chunk)
    want = _decode_math(q, k, v, lens, G)
    assert bool((got[0] == 0).all())
    atol, rtol = (1e-6, 1e-5) if dtype == "float32" else (4e-3, 1e-2)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("row_blocks,S", [(128, 32768), (3, 3000), (128, 64),
                                          (1, 100), (1024, 40), (5, 0)])
def test_split_plan_covers_the_cache_and_the_card(row_blocks, S):
    """Splits of whole 64-key tiles cover the cache once; there are
    enough to fill 132 SMs twice, unless a split would hold fewer than
    256 keys."""
    from repro_torch.kernels.decode_attention import (MIN_SPLIT_KEYS,
                                                      split_plan)

    splits, chunk = split_plan(row_blocks, S, 132)
    assert splits >= 1 and chunk % 64 == 0
    assert (splits - 1) * chunk < max(S, 1) <= splits * chunk
    if splits > 1:
        assert chunk >= MIN_SPLIT_KEYS - 63
    full = splits * row_blocks >= 2 * 132
    assert full or splits >= -(-S // MIN_SPLIT_KEYS)


def test_port_oracles_match_reference_oracles():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((3, 20, 16)).astype(np.float32)
               for _ in range(3))
    lens = np.array([1, 7, 20], np.int32)
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        np.testing.assert_allclose(
            tref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal,
                               window).numpy(),
            np.asarray(jref.attention_ref(q, k, v, causal, window)),
            atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        tref.decode_attention_ref(*map(torch.from_numpy,
                                       (q[:, 0], k, v, lens))).numpy(),
        np.asarray(jref.decode_attention_ref(q[:, 0], k, v, lens)),
        atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("b,sq,sk,kv,g,d,causal,window,qc,kc", [
    (2, 32, 32, 2, 1, 8, True, 0, 8, 8),      # the transformer's shape
    (1, 48, 48, 1, 3, 16, True, 12, 16, 8),   # GQA + window, many blocks
    (2, 20, 36, 2, 2, 8, True, 0, 7, 5),      # Sq < Sk, ragged chunks
    (1, 24, 24, 2, 1, 8, False, 0, 8, 16),    # non-causal
])
def test_models_flash_attention_matches_reference(b, sq, sk, kv, g, d, causal,
                                                  window, qc, kc):
    """Output and input gradients of the chunked streaming softmax."""
    rng = np.random.default_rng(sq + sk + d)
    q = rng.standard_normal((b, sq, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    w = rng.standard_normal((b, sq, kv, g, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, **kw) * w)

    jout = jattn.flash_attention(q, k, v, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=1e-5, rtol=1e-4)
    # skipping fully masked blocks changes nothing
    skipped = tattn.flash_attention(tq, tk, tv, skip_masked_blocks=True, **kw)
    np.testing.assert_allclose(skipped.detach().numpy(),
                               out.detach().numpy(), atol=1e-6, rtol=1e-6)


def test_models_flash_attention_valid_len_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 16, 1, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 1, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 1, 8)).astype(np.float32)
    vl = np.array([16, 9], np.int32)
    want = jattn.flash_attention(q, k, v, causal=False, q_chunk=4,
                                 kv_chunk=4, valid_len=jnp.asarray(vl))
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False, q_chunk=4, kv_chunk=4,
                                valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("head_dim,theta", [(8, 10000.0), (64, 500000.0)])
def test_rope_matches_reference(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    pos = np.arange(37, dtype=np.int32)[None, :]
    jc, js = jattn.rope_angles(jnp.asarray(pos), head_dim, theta)
    tc, ts = tattn.rope_angles(torch.from_numpy(pos), head_dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = rng.standard_normal((2, 37, 3, head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        tattn.apply_rotary(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jattn.apply_rotary(jnp.asarray(x), jc, js)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("which", ["decode", "flash"])
def test_attention_kernels_refuse_gradients(which):
    q = torch.randn(4, 8, 8, requires_grad=True)
    k, v = torch.randn(4, 8, 8), torch.randn(4, 8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        if which == "decode":
            decode_attention(q[:, 0], k, v, torch.full((4,), 8))
        else:
            flash_attention(q, k, v)
    with torch.no_grad():  # the same call without a graph is fine
        out = (decode_attention(q[:, 0], k, v, torch.full((4,), 8))
               if which == "decode" else flash_attention(q, k, v))
    assert out.grad_fn is None and torch.isfinite(out).all()


@pytest.mark.parametrize("op", ["ssd_chunk", "rmsnorm"])
def test_unported_ops_raise(op):
    """The two ops that raised ``NotImplementedError`` until they were
    ported now return results (their parity is
    ``tests/test_torch_ssd_rmsnorm.py``'s); they raise only on arguments
    of the wrong shape."""
    x = torch.zeros(2, 4)
    if op == "ssd_chunk":
        with pytest.raises(ValueError, match="ssd_chunk"):
            tops.ssd_chunk(x, x, x, x, x)
        cb = torch.zeros(2, 4, 3)
        y = tops.ssd_chunk(cb, cb, torch.ones(2, 4, 5), torch.zeros(2, 4),
                           torch.ones(2, 3, 5))
        assert y.shape == (2, 4, 5) and bool(torch.isfinite(y).all())
    else:
        with pytest.raises(ValueError, match="rmsnorm"):
            tops.rmsnorm(x, torch.ones(3))
        assert tops.rmsnorm(x + 1, torch.ones(4)).shape == (2, 4)


def test_ops_reexports_the_composition_primitives():
    from repro_torch.kernels import compose, conv_rank

    assert tops.compose is compose.compose
    assert tops.rank_dense_apply is compose.rank_dense_apply
    assert tops.compose_dense_apply is compose.compose_dense_apply
    assert tops.conv_rank_apply is conv_rank.conv_rank_apply
