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
