"""Shared helpers of the zoo families' parity tests: the same smoke config
in both packages, the reference's parameters carried across with
``convert.from_jax_params``, numpy tokens from a seed, teacher-forced
decoding through both packages, the gradient and init-tree comparisons,
and the two launchers on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import model as tmodel

TOL = 1e-4
# gradients in f32, each leaf relative to its own largest entry
GRAD_TOL = 1e-4


def cfgs(arch, moe=None, **kw):
    """(reference config, port config) of ``arch``'s smoke variant with
    ``kw`` replaced, and with ``moe`` fields replaced in its MoEConfig."""
    j, t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if moe:
        kw_j = dict(kw, moe=dataclasses.replace(j.moe, **moe))
        kw_t = dict(kw, moe=dataclasses.replace(t.moe, **moe))
        return j.replace(**kw_j), t.replace(**kw_t)
    return j.replace(**kw), t.replace(**kw)


def params(jcfg, seed=0):
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.device_get(jp), "cpu")


def tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float().numpy()
                                          if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def batch(toks, labels=None, torch_side=False, positions=None):
    conv = torch.from_numpy if torch_side else jnp.asarray
    b = {"tokens": conv(toks)}
    if labels is not None:
        b["labels"] = conv(labels)
    if positions is not None:
        b["positions"] = conv(positions)
    return b


def forward_both(jcfg, tcfg, jp, tp, b_np):
    """Logits and aux of both packages' ``forward`` on the numpy batch
    ``b_np`` (a dict of arrays)."""
    jl, jaux = jmodel.forward(jp, jcfg, {k: jnp.asarray(v)
                                         for k, v in b_np.items()})
    with torch.no_grad():
        tl, taux = tmodel.forward(tp, tcfg, {k: torch.from_numpy(v)
                                             for k, v in b_np.items()})
    return tl, np.asarray(jl, np.float32), float(taux), float(jaux)


def decode_both(jcfg, tcfg, jp, tp, toks, max_len):
    """Teacher-forced serve_step through both packages: (port logits
    (B, T, V), reference logits, port cache, reference cache)."""
    B, T = toks.shape
    jstep = jax.jit(lambda p, b, c, n: jmodel.serve_step(p, jcfg, b, c, n))
    jcache = jmodel.init_cache(jcfg, B, max_len)
    tcache = tmodel.init_cache(tcfg, B, max_len, "cpu")
    js, ts = [], []
    with torch.no_grad():
        for t in range(T):
            jl, jcache = jstep(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jcache, jnp.int32(t))
            tl, tcache = tmodel.serve_step(
                tp, tcfg, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                tcache, t)
            js.append(np.asarray(jl, np.float32))
            ts.append(tl)
    return torch.cat(ts, 1), np.concatenate(js, 1), tcache, jcache


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def grads_match(jcfg, tcfg, jp, tp, toks, tol=GRAD_TOL):
    """``loss_fn``'s gradient, leaf by leaf, against ``jax.grad`` (each
    leaf within ``tol`` of its own largest entry); returns the port's
    loss metrics."""
    labels = np.roll(toks, -1, axis=1)
    jgrads = jax.grad(lambda p: jmodel.loss_fn(
        p, jcfg, batch(toks, labels))[0])(jp)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tp = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss, met = tmodel.loss_fn(tp, tcfg, batch(toks, labels, True))
    loss.backward()
    assert len(leaves) == len(tree_leaves(tp))
    for path, want in leaves:
        want = np.asarray(want, np.float32)
        got = _leaf(tp, path).grad
        assert got is not None, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=tol,
            atol=tol * float(np.abs(want).max()),
            err_msg=jax.tree_util.keystr(path))
    return {k: v.detach() for k, v in met.items()}


def init_tree_matches(jcfg, tcfg):
    """The port's ``init`` tree against the reference's: the same keys,
    and every leaf the same shape and dtype."""
    shapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg)))
    tp = tmodel.init(0, tcfg, "cpu")

    def walk(j, t, path):
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
        else:
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == j, path

    walk(shapes, tp, ())
    return tp


def launchers_run(arch, capsys):
    """``launch/serve.py --smoke --device cpu`` serves every request and
    ``launch/train.py --smoke --device cpu --steps 2`` trains; returns
    the training launcher's output."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    r = tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert r["arch"] == arch
    assert r["done"] == r["requests"] == 8 and r["tokens"] == 128, r
    capsys.readouterr()
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "2"])
    out = capsys.readouterr().out
    assert "step    1  loss" in out and out.rstrip().endswith("done."), out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert all(np.isfinite(losses)), out
    return out
