"""The port's four kernel modules against live calls into the JAX package.

Inputs are made with numpy from a seed and fed to both.  On the CPU each
port wrapper takes its plain PyTorch version; the JAX side runs the
Pallas kernels in interpret mode (the code a TPU runs compiled) and the
reference's own custom_vjp wiring for gradients.

Tolerances (f32): 2e-5 for compose and the dense primitives; 2e-4 for
conv_rank, whose sums run over k²·I terms and where the reference's own
interpreted kernel branch and its fused-math branch already disagree
beyond 1e-5 (``tests/test_kernels.py::
test_conv_rank_fn_kernel_branch_fwd_bwd[1-3-grow_out]``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.compose import (_compose_dense_fn, _rank_dense_fn,
                                   _u2_layout as j_u2_layout,
                                   compose_apply_pallas, compose_pallas,
                                   rank_apply_pallas)
from repro.kernels.conv_rank import (_conv_rank_fn, _u2_conv_layout,
                                     conv_rank_pallas)
from repro_torch import kernels as K
from repro_torch.kernels import ref as tref
from repro_torch.kernels.compose import (compose, compose_apply_kernel,
                                         compose_dense_apply, compose_kernel,
                                         rank_apply_kernel, rank_dense_apply)
from repro_torch.kernels.conv_rank import conv_rank_apply, conv_rank_kernel

DENSE_TOL = 2e-5
CONV_TOL = 2e-4
MODES = ("square", "grow_out", "grow_in")


def _rand(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _blocks(mode, p):
    return p * p if mode == "square" else p


# the CNN's compose shapes at p=3 (conv1, conv2/conv3, fc) and a ragged one
@pytest.mark.parametrize("ksq,i,r,m,o", [
    (9, 3, 8, 3, 8), (9, 8, 8, 9, 8), (1, 8, 8, 3, 10), (4, 7, 4, 1, 5)])
def test_compose_matches_pallas(ksq, i, r, m, o):
    v, u = _rand(ksq * 100 + i, (ksq, i, r), (m, r, o))
    want = compose_pallas(jnp.asarray(v), jnp.asarray(u), interpret=True)
    _close(compose(_t(v), _t(u)).numpy(), want, DENSE_TOL)
    _close(compose_kernel(_t(v), _t(u)).numpy(), want, DENSE_TOL)


def test_compose_client_axis_matches_pallas():
    """The 4-d form: a leading client axis C=4 in one call."""
    v, u = _rand(7, (4, 9, 8, 8), (4, 9, 8, 8))
    want = compose_pallas(jnp.asarray(v), jnp.asarray(u), interpret=True)
    got = compose(_t(v), _t(u))
    assert tuple(got.shape) == (4, 9, 8, 72)
    _close(got.numpy(), want, DENSE_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_compose_grads_match_jax(batched):
    lead = (3,) if batched else ()
    v, u, g = _rand(11, lead + (9, 8, 8), lead + (4, 8, 6),
                    lead + (9, 8, 24))

    def jloss(v_, u_):
        return jnp.sum(compose_pallas(v_, u_, interpret=True) * g)

    jdv, jdu = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(u))
    tv, tu = _t(v).requires_grad_(), _t(u).requires_grad_()
    (compose(tv, tu) * _t(g)).sum().backward()
    _close(tv.grad.numpy(), jdv, DENSE_TOL)
    _close(tu.grad.numpy(), jdu, DENSE_TOL)


def _dense_inputs(mode, p, seed, M=16, I=8, R=8, O=10):
    g = 1 if mode == "grow_out" else p
    x, v, u = _rand(seed, (M, g * I), (1, I, R), (_blocks(mode, p), R, O),
                    scale=0.5)
    return x, v, u, g


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 3])
def test_dense_primitives_match_pallas(mode, p):
    """rank_dense_apply / compose_dense_apply and their kernel wrappers vs
    rank_apply_pallas / compose_apply_pallas (interpret) at the CNN's
    classifier-head width."""
    x, v, u, g = _dense_inputs(mode, p, seed=10 * p)
    xg = x.reshape(x.shape[0], g, -1)
    u2 = np.asarray(j_u2_layout(jnp.asarray(u), p, mode))
    u3 = u2.reshape(g, u.shape[1], -1)
    want_rank = rank_apply_pallas(jnp.asarray(xg), jnp.asarray(v[0]),
                                  jnp.asarray(u2), interpret=True)
    want_comp = compose_apply_pallas(jnp.asarray(xg), jnp.asarray(v[0]),
                                     jnp.asarray(u3), interpret=True)
    _close(rank_apply_kernel(_t(xg), _t(v[0]), _t(u2)).numpy(), want_rank,
           DENSE_TOL)
    _close(compose_apply_kernel(_t(xg), _t(v[0]), _t(u3)).numpy(),
           want_comp, DENSE_TOL)
    _close(rank_dense_apply(_t(x), _t(v), _t(u), p, mode).numpy(),
           want_rank, DENSE_TOL)
    _close(compose_dense_apply(_t(x), _t(v), _t(u), p, mode).numpy(),
           want_comp, DENSE_TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3])
def test_dense_primitive_grads_match_jax(fused, mode, p):
    """The rank-space backward vs jax.grad through the reference's
    kernel-branch custom_vjp (Pallas forward in interpret mode)."""
    x, v, u, _ = _dense_inputs(mode, p, seed=5 + p)
    jfn = (_compose_dense_fn if fused else _rank_dense_fn)(
        p, mode, True, kernel_interpret=True)
    tfn = compose_dense_apply if fused else rank_dense_apply

    def jloss(x_, v_, u_):
        return jnp.sum(jnp.sin(jfn(x_, v_[0], u_)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(u))
    targs = [_t(a).requires_grad_() for a in (x, v, u)]
    torch.sin(tfn(*targs, p, mode)).sum().backward()
    for ta, ja in zip(targs, jgrads):
        _close(ta.grad.numpy(), ja, DENSE_TOL)


def _conv_inputs(mode, p, seed, N=2, H=8, I=6, R=8, O=5):
    g = 1 if mode == "grow_out" else p
    x, v, u = _rand(seed, (N, H, H, g * I), (9, I, R),
                    (_blocks(mode, p), R, O), scale=0.5)
    return x, v, u


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_rank_matches_pallas_and_ref(mode, p, stride):
    """conv_rank_apply and its kernel wrapper vs conv_rank_pallas
    (interpret) and the compose-then-conv oracle; stride 2 covers XLA's
    asymmetric SAME padding."""
    x, v, u = _conv_inputs(mode, p, seed=p + 3 * stride)
    u2 = np.asarray(_u2_conv_layout(jnp.asarray(u), p, mode))
    want = conv_rank_pallas(jnp.asarray(x), jnp.asarray(v), jnp.asarray(u2),
                            p=p, mode=mode, stride=stride, interpret=True)
    oracle = jref.conv_rank_ref(jnp.asarray(x), jnp.asarray(v),
                                jnp.asarray(u), p, mode, stride)
    got = conv_rank_apply(_t(x), _t(v), _t(u), p, mode, stride=stride)
    _close(got.numpy(), want, CONV_TOL)
    _close(got.numpy(), oracle, CONV_TOL)
    _close(conv_rank_kernel(_t(x), _t(v), _t(u2), p=p, mode=mode,
                            stride=stride).numpy(), want, CONV_TOL)
    _close(tref.conv_rank_ref(_t(x), _t(v), _t(u), p, mode, stride).numpy(),
           oracle, CONV_TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_rank_grads_match_jax(mode, p, stride):
    """The rank-space backward (dx, dbasis, du) vs jax.grad through the
    reference's kernel-branch custom_vjp (interpret)."""
    x, v, u = _conv_inputs(mode, p, seed=20 + p, N=2, H=6)
    jfn = _conv_rank_fn(p, mode, stride, True, kernel_interpret=True)

    def jloss(*args):
        return jnp.sum(jnp.sin(jfn(*args)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(u))
    targs = [_t(a).requires_grad_() for a in (x, v, u)]
    torch.sin(conv_rank_apply(*targs, p, mode, stride=stride)).sum().backward()
    for ta, ja in zip(targs, jgrads):
        _close(ta.grad.numpy(), ja, CONV_TOL)


def test_plain_versions_count_no_launches():
    """On the CPU the wrappers take their plain versions: no kernel runs,
    so no launch is counted."""
    before = dict(K.LAUNCHES)
    v, u = _rand(1, (9, 8, 8), (9, 8, 8))
    compose_kernel(_t(v), _t(u))
    x, vd, ud, _ = _dense_inputs("grow_in", 3, seed=1)
    rank_dense_apply(_t(x), _t(vd), _t(ud), 3, "grow_in")
    compose_dense_apply(_t(x), _t(vd), _t(ud), 3, "grow_in")
    xc, vc, uc = _conv_inputs("square", 2, seed=1)
    conv_rank_apply(_t(xc), _t(vc), _t(uc), 2, "square", stride=2)
    assert K.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    """Only a CPU tensor reaches a plain version; a tensor on another
    device (here ``meta``) raises rather than silently running it."""
    v = torch.empty((9, 8, 8), device="meta")
    u = torch.empty((9, 8, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        compose_kernel(v, u)
    with pytest.raises(ValueError, match="device"):
        rank_apply_kernel(torch.empty((4, 1, 8), device="meta"),
                          torch.empty((8, 8), device="meta"),
                          torch.empty((8, 10), device="meta"))
    with pytest.raises(ValueError, match="device"):
        conv_rank_kernel(torch.empty((1, 8, 8, 8), device="meta"), v,
                         torch.empty((8, 8), device="meta"), p=1)


# --------------------------------------------------------------------------
# launch geometry of the conv_rank and rank_apply kernels
# --------------------------------------------------------------------------

def _conv_geometry_cases():
    """(N, H, g, I, R, D, stride): the CNN's convs (conv1 grow_out at 8x8,
    conv2 square at 8x8 and conv3 square at 4x4, both stride 2) at
    widths 1-3 over a training batch (1 to 16 images) and the 400-image
    test set; every mode and stride of phase 2 at 8x8; the cifar10
    task's 32x32; odd sizes 7 and 5; rank 6; a wide basis past 48 KB."""
    cases = set()
    for p in (1, 2, 3):
        for N in (1, 16, 400):
            cases.add((N, 8, 1, 3, 8, 8 * p, 1))
            cases.add((N, 8, p, 8, 8, 8 * p, 2))
            cases.add((N, 4, p, 8, 8, 8 * p, 2))
        for stride in (1, 2):
            cases.add((16, 8, p, 8, 8, 8, stride))      # grow_in
            cases.add((16, 8, p, 8, 8, 8 * p, stride))  # square
            cases.add((16, 8, 1, 3, 8, 8 * p, stride))  # grow_out
            for hw in (7, 5, 32):
                cases.add((16, hw, p, 8, 8, 8 * p, stride))
                cases.add((16, hw, 1, 3, 8, 8 * p, stride))
    cases.add((2, 8, 1, 192, 8, 8, 1))
    cases.add((3, 7, 2, 3, 6, 8, 1))  # phase 2's rank-6 edge
    return sorted(cases)


@pytest.mark.parametrize("N,H,g,I,R,D,stride", _conv_geometry_cases())
def test_conv_rank_tiles_cover_every_output_once(N, H, g, I, R, D, stride):
    """Each block's rectangle, as ``conv_rank_kernel`` derives it from its
    block index, covers every output pixel of every image exactly once,
    and the block's tiles fit in shared memory."""
    from repro_torch.kernels import conv_rank as cr

    Ho, _ = cr._same_pads(H, 3, stride)
    th, tw, smem = cr._conv_tiles(N, Ho, Ho, g, I, R, D, 3, stride)
    assert 1 <= th <= Ho and 1 <= tw <= Ho and th * tw <= cr.TILE_PIX
    assert smem == cr._conv_smem(g, I, R, D, 3, stride, th, tw)
    assert smem <= K.SMEM_MAX
    tiles_w, tiles_h = -(-Ho // tw), -(-Ho // th)
    seen = np.zeros((N, Ho, Ho), np.int64)
    for b in range(N * tiles_h * tiles_w):
        n, tile = divmod(b, tiles_w * tiles_h)
        ho0, wo0 = (tile // tiles_w) * th, (tile % tiles_w) * tw
        rows, cols = min(th, Ho - ho0), min(tw, Ho - wo0)
        assert rows >= 1 and cols >= 1
        seen[n, ho0:ho0 + rows, wo0:wo0 + cols] += 1
    assert (seen == 1).all()
    if (N, H, g, stride) == (16, 8, 3, 2) and D == 24:
        assert N * tiles_h * tiles_w >= 64  # conv2's timed shape: 16 before


def _rank_geometry_cases():
    """(M, g, I, R, D): the CNN's head (grow_in, D = 10) at widths 1-3
    and the composed transformer's projections (d_base 16, ff 32,
    vocab 64) at p = 1-3, over M in {1, 16, 17, 256, 1000}; rank 6 on
    rows of 9 floats; a wide basis past 48 KB."""
    cases = set()
    for M in (1, 16, 17, 256, 1000):
        for p in (1, 2, 3):
            cases.add((M, p, 8, 8, 10))       # fc grow_in
            cases.add((M, 1, 8, 8, 10 * p))   # grow_out
            cases.add((M, p, 8, 8, 10 * p))   # square
            for I, O in ((16, 16), (16, 32), (32, 16)):
                cases.add((M, p, I, 8, O * p))
            cases.add((M, p, 16, 8, 64))      # head grow_in
    cases.add((16, 1, 2048, 8, 10))
    cases.add((17, 3, 3, 6, 6))  # phase 2's unaligned, rank-6 edge
    return sorted(cases)


@pytest.mark.parametrize("M,g,I,R,D", _rank_geometry_cases())
def test_rank_apply_tiles_cover_every_output_once(M, g, I, R, D):
    from repro_torch.kernels import compose as cm

    bm, bd, smem = cm._rank_apply_tiles(M, g, I, R, D)
    assert 1 <= bm <= cm.RA_ROWS and bd % 4 == 0 and 4 <= bd <= cm.RA_COLS
    assert smem == cm._rank_apply_smem(g, I, R, bm, bd) <= K.SMEM_MAX
    seen = np.zeros((M, D), np.int64)
    for bx in range(-(-M // bm)):
        for by in range(-(-D // bd)):
            m0, d0 = bx * bm, by * bd
            rows, cols = min(bm, M - m0), min(bd, D - d0)
            assert rows >= 1 and cols >= 1
            seen[m0:m0 + rows, d0:d0 + cols] += 1
    assert (seen == 1).all()
    if (M, g, I, D) == (256, 3, 16, 96):  # path (e)'s up: 16 blocks before
        assert -(-M // bm) * -(-D // bd) >= 128


def test_launchers_opt_into_large_shared_memory():
    """The wide cases the card's checks run (conv_rank on one group of
    192 channels, rank_apply on 2048 inputs) tile into blocks past the
    default 48 KB, which the launchers then opt into, and within the
    card's 227 KB."""
    from repro_torch.kernels import compose as cm
    from repro_torch.kernels import conv_rank as cr

    conv = cr._conv_tiles(2, 8, 8, 1, 192, 8, 8, 3, 1)[2]
    rank = cm._rank_apply_tiles(16, 1, 2048, 8, 10)[2]
    for smem in (conv, rank):
        assert K.SMEM_DEFAULT < smem <= K.SMEM_MAX


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3])
def test_rank_apply_pair_matches_plain_and_residual(mode, p):
    """With ``with_t`` the wrapper hands back (y, t): y as the plain
    version computes it, t the rank-space residual the backward reads."""
    from repro_torch.kernels.compose import _fwd_math

    x, v, u, g = _dense_inputs(mode, p, seed=30 + p, M=17, I=16)
    xg = _t(x).reshape(17, g, -1)
    u2 = _t(np.asarray(j_u2_layout(jnp.asarray(u), p, mode)))
    y, t = rank_apply_kernel(xg, _t(v[0]), u2, with_t=True)
    torch.testing.assert_close(y, _fwd_math(xg, _t(v[0]), u2), rtol=0,
                               atol=0)
    torch.testing.assert_close(rank_apply_kernel(xg, _t(v[0]), u2), y,
                               rtol=0, atol=0)
    assert t.shape == (17, g, 8)
    _close(t.numpy(), _reference_residual(xg, v[0]), DENSE_TOL)


def _reference_residual(xg, v2):
    """The residual t the reference's custom_vjp ``fwd`` saves
    (``_compose_dense_fn`` and ``_rank_dense_fn``), from live jnp."""
    return jnp.einsum("mgi,ir->mgr", jnp.asarray(np.asarray(xg)),
                      jnp.asarray(v2))


def _compose_apply_geometry_cases():
    """(M, g, I, R, D): the CNN's head (grow_in, D = 10) at widths 1-3, the
    calibration's head (32 rows, p = 2) and the composed transformer's
    projections (d_base 16, ff 32, vocab 64) at p = 1-3, over M in {1,
    16, 17, 256, 1000}; rank 6 on rows of 9 floats; a wide basis past 48
    KB (I = 2048) and a weight tile built in chunks (g*I = 1536)."""
    cases = set()
    for M in (1, 16, 17, 32, 256, 1000):
        for p in (1, 2, 3):
            cases.add((M, p, 8, 8, 10))       # fc grow_in
            cases.add((M, 1, 8, 8, 10 * p))   # grow_out
            cases.add((M, p, 8, 8, 10 * p))   # square
            for I, O in ((16, 16), (16, 32), (32, 16)):
                cases.add((M, p, I, 8, O * p))
            cases.add((M, p, 16, 8, 64))      # head grow_in
    cases.add((16, 1, 2048, 8, 10))
    cases.add((5, 3, 512, 8, 40))
    cases.add((17, 3, 3, 6, 6))
    return sorted(cases)


@pytest.mark.parametrize("M,g,I,R,D", _compose_apply_geometry_cases())
def test_compose_apply_tiles_cover_every_output_once(M, g, I, R, D):
    """Each block's (rows, columns) rectangle covers every output exactly
    once, each weight chunk's rows cover g*I exactly once, and the block
    fits in shared memory: within 48 KB unless even the smallest chunk
    does not fit there."""
    from repro_torch.kernels import compose as cm

    bm, bd, kc, smem = cm._compose_apply_tiles(M, g, I, R, D)
    assert 1 <= bm <= cm.CA_ROWS and bd % 4 == 0 and 4 <= bd <= cm.CA_COLS
    assert smem == cm._compose_apply_smem(g, I, R, bm, bd, kc) <= K.SMEM_MAX
    staged = cm._compose_apply_smem(g, I, R, bm, bd, 0)
    if smem > K.SMEM_DEFAULT:
        assert staged + 4 * bd * min(g * I, cm.CA_CHUNK_MIN) > K.SMEM_DEFAULT
    assert 1 <= kc <= g * I
    if kc < g * I:  # chunks only where the whole tile does not fit
        assert staged + 4 * bd * g * I > K.SMEM_DEFAULT
    rows_seen = np.zeros(g * I, np.int64)
    for k0 in range(0, g * I, kc):
        rows_seen[k0:k0 + min(kc, g * I - k0)] += 1
    assert (rows_seen == 1).all()
    seen = np.zeros((M, D), np.int64)
    for bx in range(-(-M // bm)):
        for by in range(-(-D // bd)):
            m0, d0 = bx * bm, by * bd
            rows, cols = min(bm, M - m0), min(bd, D - d0)
            assert rows >= 1 and cols >= 1
            seen[m0:m0 + rows, d0:d0 + cols] += 1
    assert (seen == 1).all()
    if (M, g, I, D) == (16, 3, 8, 10):  # the fc head: 1 block before
        assert -(-M // bm) * -(-D // bd) >= 8
    if (M, g, I, D) == (256, 3, 16, 64):  # the wide timed shape
        assert -(-M // bm) * -(-D // bd) >= 128
    if (g, I) == (1, 2048):
        assert K.SMEM_DEFAULT < smem and kc == g * I
    if (g, I) == (3, 512):
        assert smem <= K.SMEM_DEFAULT and kc < g * I


def _compose_geometry_cases():
    """(C, ksq, I, R, m, O): the CNN's compose calls (conv1, conv2/conv3,
    fc) at p = 1-3, the fc layer's ragged m*O (10, 20, 30), the cohort
    stack up to C = 10, the composed transformer's projections (p = 1-3),
    rank 6, a rank in the thousands and m*O past one column tile."""
    cases = set()
    for p in (1, 2, 3):
        for C in (1, 4, 10):
            cases.add((C, 9, 3, 8, p, 8))
            cases.add((C, 9, 8, 8, p * p, 8))
            cases.add((C, 1, 8, 8, p, 10))
        for I, O in ((16, 16), (16, 32), (32, 16)):
            cases.add((1, 1, I, 8, p * p, O))
        cases.add((1, 1, 16, 8, p, 64))
    cases.add((1, 9, 3, 6, 3, 10))
    cases.add((10, 4, 7, 6, 1, 5))
    cases.add((1, 1, 4, 3000, 1, 8))
    cases.add((2, 300, 5, 8, 7, 37))
    return sorted(cases)


@pytest.mark.parametrize("C,ksq,I,R,m,O", _compose_geometry_cases())
def test_compose_tiles_cover_every_output_once(C, ksq, I, R, m, O):
    """Each (client, row tile, column tile) block covers every output of
    the (C, ksq*I, m*O) result exactly once, with at most 128 threads,
    whether a thread owns four columns or one (the wrapper's choice where
    O or R is not a multiple of 4, or O >= 32); each column's block b, as
    the kernel derives it with its reciprocal of O, is j // O."""
    from repro_torch.kernels import compose as cm

    rows, MO = ksq * I, m * O
    for cw in (4, 1):
        by, cx = cm._compose_tiles(ksq * I, m, O, cw)
        assert 1 <= by <= rows and 1 <= cx
        assert cx <= (cm.CO_QUADS if cw == 4 else cm.CO_COLS)
        assert by * cx <= cm.CO_THREADS
        seen = np.zeros((C, rows, MO), np.int64)
        n_rows, n_cols = -(-rows // by), -(-MO // (cw * cx))
        for c in range(C):
            for bx in range(n_rows):
                for bj in range(n_cols):
                    r0, j0 = bx * by, bj * cw * cx
                    assert r0 < rows and j0 < MO
                    seen[c, r0:r0 + by, j0:j0 + cw * cx] += 1
        assert (seen == 1).all()
    inv_o = -(-(1 << 32) // O)
    j = np.arange(MO, dtype=np.uint64)
    assert ((j * np.uint64(inv_o)) >> np.uint64(32) == j // O).all()
    if (C, ksq, I, m, O) == (1, 9, 8, 9, 8):  # conv2: full blocks
        by, cx = cm._compose_tiles(ksq * I, m, O)
        assert by * cx == cm.CO_THREADS


@pytest.mark.parametrize("ksq,I,R,m,O,offset,cw", [
    (9, 8, 8, 9, 8, 0, 4),     # conv2: four columns a thread
    (9, 3, 8, 3, 8, 0, 4),     # conv1
    (1, 8, 8, 3, 10, 0, 1),    # fc: O = 10 rules out float4 rows
    (1, 16, 8, 9, 32, 0, 1),   # path (e)'s up: O = 32, whole lines
    (9, 3, 6, 3, 8, 0, 1),     # rank 6
    (9, 8, 8, 9, 8, 1, 1)])    # a coefficient view off 16 bytes
def test_compose_width_rule(ksq, I, R, m, O, offset, cw):
    """The columns a compose thread owns: four where O and R are
    multiples of 4, O < 32 and every operand is 16-byte aligned."""
    from repro_torch.kernels import compose as cm

    basis = torch.zeros((ksq, I, R))
    coeff = torch.zeros(m * R * O + offset)[offset:].reshape(m, R, O)
    out = torch.zeros((ksq, I, m * O))
    assert cm._compose_width(basis, coeff, out) == cw


def test_tiles_refuse_what_does_not_fit():
    """compose_apply raises where v and one xg row pass 227 KB; compose
    where its reciprocal of O would not give j // O exactly."""
    from repro_torch.kernels import compose as cm

    with pytest.raises(ValueError, match="shared memory"):
        cm._compose_apply_tiles(16, 1, 8000, 8, 10)
    with pytest.raises(ValueError, match="2\\^32"):
        cm._compose_tiles(8, 1, 70000)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [1, 3])
def test_compose_apply_pair_matches_plain_and_residual(mode, p):
    """With ``with_t`` compose_apply hands back (y, t): y as the plain
    version and the Pallas kernel (interpret) compute it, t the
    reference's residual ``einsum("mgi,ir->mgr")``."""
    from repro_torch.kernels.compose import _compose_apply_math

    x, v, u, g = _dense_inputs(mode, p, seed=40 + p, M=17, I=16)
    xg = _t(x).reshape(17, g, -1)
    u3 = _t(np.asarray(j_u2_layout(jnp.asarray(u), p, mode))).reshape(
        g, 8, -1)
    y, t = compose_apply_kernel(xg, _t(v[0]), u3, with_t=True)
    torch.testing.assert_close(y, _compose_apply_math(xg, _t(v[0]), u3),
                               rtol=0, atol=0)
    torch.testing.assert_close(compose_apply_kernel(xg, _t(v[0]), u3), y,
                               rtol=0, atol=0)
    want = compose_apply_pallas(jnp.asarray(xg.numpy()), jnp.asarray(v[0]),
                                jnp.asarray(u3.numpy()), interpret=True)
    _close(y.numpy(), want, DENSE_TOL)
    assert t.shape == (17, g, 8)
    _close(t.numpy(), _reference_residual(xg, v[0]), DENSE_TOL)


def _check_dense_residual_routing(monkeypatch, kernel_name, dense_fn):
    """The dense wrapper asks its kernel for no residual without a
    recorded graph: under ``torch.no_grad()``, also on operands that
    require grad, and in grad mode on operands that do not.  A recorded
    forward asks the kernel for t (one call, ``with_t=True``) and saves it
    for the backward, within ``DENSE_TOL`` of the reference's residual."""
    from repro_torch.kernels import compose as cm

    calls = []
    kernel = getattr(cm, kernel_name)

    def counting(*args, **kw):
        calls.append(kw.get("with_t", False))
        return kernel(*args, **kw)

    monkeypatch.setattr(cm, kernel_name, counting)
    x, v, u, _ = _dense_inputs("grow_in", 3, seed=50)
    with torch.no_grad():
        y0 = dense_fn(_t(x), _t(v), _t(u), 3, "grow_in")
        targs = [_t(a).requires_grad_() for a in (x, v, u)]
        y1 = dense_fn(*targs, 3, "grow_in")
    y2 = dense_fn(_t(x), _t(v), _t(u), 3, "grow_in")
    assert calls == [False, False, False]
    assert y1.grad_fn is None and y2.grad_fn is None
    calls.clear()
    y = dense_fn(*targs, 3, "grow_in")
    assert calls == [True]
    for other in (y1, y2):
        torch.testing.assert_close(other, y0, rtol=0, atol=0)
    torch.testing.assert_close(y.detach(), y0, rtol=0, atol=0)
    node = y.grad_fn.next_functions[0][0]  # the Function under the reshape
    t = node.saved_tensors[3]
    _close(t.numpy(), _reference_residual(_t(x).reshape(16, 3, -1), v[0]),
           DENSE_TOL)


def test_compose_dense_apply_no_grad_runs_no_residual(monkeypatch):
    """compose_dense_apply launches compose_apply alone unless a graph is
    recorded (``_check_dense_residual_routing``)."""
    _check_dense_residual_routing(monkeypatch, "compose_apply_kernel",
                                  compose_dense_apply)


def test_rank_dense_apply_no_grad_runs_no_residual(monkeypatch):
    """rank_dense_apply launches rank_apply alone unless a graph is
    recorded (``_check_dense_residual_routing``)."""
    _check_dense_residual_routing(monkeypatch, "rank_apply_kernel",
                                  rank_dense_apply)
