"""The port's SSD-chunk and RMSNorm kernels against the JAX package's.

* ``kernels.ops.ssd_chunk`` and ``kernels.ops.rmsnorm`` (on the CPU: the
  kernels' plain versions) against the reference's Pallas kernels in
  interpret mode and against the oracles of both packages, over the
  reference's sweep shapes (``tests/test_kernels.py``) in f32 and bf16,
  at that file's tolerances: 16x its per-type tolerance for ssd_chunk,
  4x for rmsnorm, relative and absolute.
* ``ssd_chunk`` with ``heads > 1`` (B and C passed once per group)
  against the call with B and C replicated per head; a chunk whose upper
  triangle would overflow ``exp`` stays finite.
* ``models.ssm.ssd_chunked`` against the reference's, with a non-zero
  initial state, several chunks and padding: y and the final state.
* The shapes the bf16 kernels' other code paths take: ``heads = 8`` over
  a ragged chunk (Q = 100), the widest state (N = 128), zamba2's rmsnorm
  widths (2560, 5120) with few rows, and ``ssd_chunked`` with 8 heads,
  N = 128 and a padded last chunk.
* Both kernels refuse to record a gradient (the reference's
  ``pallas_call`` has none).

Inputs are drawn with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SSD_SWEEP = [(4, 32, 8, 16), (2, 64, 16, 32), (1, 16, 4, 8), (3, 24, 4, 12)]
# the reference's sweep, then zamba2-2.7b's d_model and d_inner at
# decode's few rows
RMS_SWEEP = [(4, 64), (2, 7, 96), (1, 130, 32), (4, 2560), (4, 5120)]


def _pair(x: np.ndarray, dtype):
    """The same f32 values as a jax array and a torch tensor of
    ``dtype`` (both round to bf16 to nearest even)."""
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _ssd_inputs(rng, b, q, n, p, dtype):
    cb, bb = (_pair(rng.standard_normal((b, q, n)), dtype) for _ in "cb")
    xw = _pair(rng.standard_normal((b, q, p)), dtype)
    # cum (log-decay) stays f32, as in the reference's contract
    cum = -np.cumsum(np.logaddexp(0.0, rng.standard_normal((b, q))), 1)
    cum = _pair(cum, "float32")
    hin = _pair(rng.standard_normal((b, n, p)), dtype)
    return cb, bb, xw, cum, hin


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,q,n,p", SSD_SWEEP)
def test_ssd_chunk_matches_reference(dtype, b, q, n, p):
    rng = np.random.default_rng(q + p)
    args = _ssd_inputs(rng, b, q, n, p, dtype)
    got = tops.ssd_chunk(*(t for _, t in args))
    assert got.shape == (b, q, p) and got.dtype == TDT[dtype]
    tol = 16 * TOL[dtype]
    _close(got, jops.ssd_chunk(*(j for j, _ in args), interpret=True), tol)
    f32 = [j.astype(jnp.float32) for j, _ in args]
    _close(got, jref.ssd_chunk_ref(*f32), tol)
    _close(got, tref.ssd_chunk_ref(*(t.float() for _, t in args)).numpy(),
           tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [2, 5])
def test_ssd_chunk_heads_match_replicated_rows(dtype, heads):
    rng = np.random.default_rng(heads)
    G, Q, N, P = 3, 40, 8, 16
    _, cb = _pair(rng.standard_normal((G, Q, N)), dtype)
    _, bb = _pair(rng.standard_normal((G, Q, N)), dtype)
    R = G * heads
    (_, xw), (_, cum), (_, hin) = _ssd_inputs(rng, R, Q, N, P, dtype)[2:]
    got = tops.ssd_chunk(cb, bb, xw, cum, hin, heads=heads)
    want = tops.ssd_chunk(cb.repeat_interleave(heads, 0),
                          bb.repeat_interleave(heads, 0), xw, cum, hin)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="heads"):
        tops.ssd_chunk(cb, bb, xw, cum, hin, heads=heads + 1)


def test_ssd_chunk_overflowing_upper_triangle_stays_finite():
    """Steep decay: exp(cum_i - cum_j) overflows for j > i, where the
    mask must give 0 (not inf * 0 = NaN), as the reference's ``where``."""
    rng = np.random.default_rng(7)
    args = list(_ssd_inputs(rng, 2, 32, 4, 8, "float32"))
    cum = np.cumsum(-40.0 * np.ones((2, 32)), 1)
    args[3] = _pair(cum, "float32")
    got = tops.ssd_chunk(*(t for _, t in args))
    assert bool(torch.isfinite(got).all())
    _close(got, jops.ssd_chunk(*(j for j, _ in args), interpret=True),
           16 * TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SWEEP)
def test_rmsnorm_matches_reference(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    js, ts = _pair(1.0 + 0.1 * rng.standard_normal(shape[-1]), "float32")
    got = tops.rmsnorm(tx, ts)
    assert got.shape == shape and got.dtype == TDT[dtype]
    tol = 4 * TOL[dtype]
    _close(got, jops.rmsnorm(jx, js, interpret=True), tol)
    _close(got, jref.rmsnorm_ref(jx.astype(jnp.float32), js).astype(
        JDT[dtype]), tol)
    _close(got, tref.rmsnorm_ref(tx, ts).float().numpy(), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,heads,Q,N,P", [(2, 8, 100, 16, 16),
                                           (2, 3, 64, 128, 32)])
def test_ssd_chunk_heads_and_wide_state_match_reference(dtype, G, heads, Q,
                                                        N, P):
    """B and C passed once per group to the port, replicated per head for
    the reference (its layout)."""
    rng = np.random.default_rng(Q + N)
    cb = _pair(rng.standard_normal((G, Q, N)), dtype)
    bb = _pair(rng.standard_normal((G, Q, N)), dtype)
    R = G * heads
    xw, cum, hin = _ssd_inputs(rng, R, Q, N, P, dtype)[2:]
    got = tops.ssd_chunk(cb[1], bb[1], xw[1], cum[1], hin[1], heads=heads)
    assert got.shape == (R, Q, P) and got.dtype == TDT[dtype]
    jrep = [jnp.repeat(j, heads, axis=0) for j in (cb[0], bb[0])]
    tol = 16 * TOL[dtype]
    _close(got, jops.ssd_chunk(*jrep, xw[0], cum[0], hin[0], interpret=True),
           tol)
    f32 = [j.astype(jnp.float32) for j in (*jrep, xw[0], cum[0], hin[0])]
    _close(got, jref.ssd_chunk_ref(*f32), tol)


def test_ssd_chunked_matches_reference():
    """T = 80 over chunks of 32: three chunks, the last padded by 16, and
    a non-zero state entering the first."""
    rng = np.random.default_rng(0)
    B, T, H, P, N, Q = 2, 80, 3, 8, 4, 32
    jx, tx = _pair(rng.standard_normal((B, T, H, P)), "float32")
    dt = np.logaddexp(0.0, rng.standard_normal((B, T, H)) - 1.0)
    jdt, tdt = _pair(dt, "float32")
    jA, tA = _pair(np.exp(np.log(np.linspace(1.0, 16.0, H))), "float32")
    jb, tb = _pair(rng.standard_normal((B, T, N)), "float32")
    jc, tc = _pair(rng.standard_normal((B, T, N)), "float32")
    jh, th = _pair(rng.standard_normal((B, H, N, P)), "float32")
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jb, jc, Q, init_state=jh)
    ty, tst = tssm.ssd_chunked(tx, tdt, tA, tb, tc, Q, init_state=th)
    assert ty.shape == (B, T, H, P) and tst.shape == (B, H, N, P)
    _close(ty, jy, 1e-5)
    _close(tst, jst, 1e-5)


def test_ssd_chunked_heads_wide_state_matches_reference():
    """T = 100 over chunks of 64 (the last padded by 28), 8 heads sharing
    B and C of N = 128, a non-zero state entering the first chunk."""
    rng = np.random.default_rng(1)
    B, T, H, P, N, Q = 1, 100, 8, 16, 128, 64
    jx, tx = _pair(rng.standard_normal((B, T, H, P)), "float32")
    dt = np.logaddexp(0.0, rng.standard_normal((B, T, H)) - 1.0)
    jdt, tdt = _pair(dt, "float32")
    jA, tA = _pair(np.linspace(0.5, 4.0, H), "float32")
    jb, tb = _pair(rng.standard_normal((B, T, N)) / np.sqrt(N), "float32")
    jc, tc = _pair(rng.standard_normal((B, T, N)) / np.sqrt(N), "float32")
    jh, th = _pair(rng.standard_normal((B, H, N, P)), "float32")
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jb, jc, Q, init_state=jh)
    ty, tst = tssm.ssd_chunked(tx, tdt, tA, tb, tc, Q, init_state=th)
    assert ty.shape == (B, T, H, P) and tst.shape == (B, H, N, P)
    _close(ty, jy, 1e-5)
    _close(tst, jst, 1e-5)


def test_kernels_refuse_grad():
    """The kernel wrappers are forward-only; ``kernels.ops`` gives them a
    backward (the plain versions'), so through ops the same calls take a
    gradient."""
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rmsnorm(x, torch.ones(8))
    cb = torch.randn(1, 8, 4, requires_grad=True)
    ssd_args = (torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                torch.zeros(1, 8), torch.randn(1, 4, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_chunk(cb, *ssd_args)
    with torch.no_grad():
        assert rmsnorm(x, torch.ones(8)).shape == (4, 8)
    tops.rmsnorm(x, torch.ones(8)).sum().backward()
    tops.ssd_chunk(cb, *ssd_args).sum().backward()
    assert x.grad is not None and cb.grad is not None
