"""The port's M-RoPE and the vlm family (qwen2-vl-7b) against the JAX
package's, on the smoke config in f32 (sections (8, 4, 4), GQA with 4
query heads per KV head), on the same numpy inputs:

* ``mrope_angles`` on (B, 3, S) position ids whose t, h and w rows all
  differ (so a wrong section order fails), a section sum that does not
  match raising, and its reduction to ``rope_angles`` when the three rows
  are equal (text);
* ``forward`` with distinct t/h/w positions, with the text default and
  with patch ``embeddings``; ``loss_fn`` and its gradient;
  teacher-forced ``serve_step`` (positions ``(B, 3, 1)`` from
  ``cache_len``) against the reference's and the forward;
* the serving launcher's ``(B, 3, 1)`` positions, the init tree, and both
  launchers on the CPU (the training launcher's stub-frontend note).

Tolerance: 1e-4 (``TOL``) on every f32 output, and on each gradient leaf
relative to its own largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from torch_threads import one_thread  # noqa: F401
from torch_zoo_parity import (batch, cfgs, close, decode_both, forward_both,
                              grads_match, init_tree_matches, launchers_run,
                              params, tokens)

ARCH = "qwen2-vl-7b"

_F32 = {}


def _f32():
    if not _F32:
        jcfg, tcfg = cfgs(ARCH, compute_dtype="float32")
        _F32["v"] = (jcfg, tcfg, *params(jcfg))
    return _F32["v"]


def _vision_positions(B, S, seed=0):
    """(B, 3, S) ids as a vision prefix makes them: t counts frames, h
    and w walk a patch grid, so no two rows are equal."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, S, (B, S)), axis=1)
    h = rng.integers(0, 9, (B, S))
    w = rng.integers(0, 13, (B, S)) + 20
    return np.stack([t, h, w], axis=1).astype(np.int32)


@pytest.mark.parametrize("sections,head_dim", [((8, 4, 4), 32),
                                               ((16, 24, 24), 128)])
def test_mrope_angles_match_reference(sections, head_dim):
    pos = _vision_positions(2, 11)
    jc, js = jattention.mrope_angles(jnp.asarray(pos), head_dim, 1e6,
                                     sections)
    tc, ts = tattention.mrope_angles(torch.from_numpy(pos), head_dim, 1e6,
                                     sections)
    assert tc.shape == (2, 11, head_dim // 2)
    close(tc, jc, 1e-6)
    close(ts, js, 1e-6)
    # each section reads its own row: with t and h swapped, it differs
    sw, _ = tattention.mrope_angles(torch.from_numpy(pos[:, [1, 0, 2]]),
                                    head_dim, 1e6, sections)
    assert float((sw - tc).abs().max()) > 0.1


def test_mrope_sections_must_fill_half_the_head():
    with pytest.raises(ValueError, match="sections"):
        tattention.mrope_angles(torch.zeros((1, 3, 4), dtype=torch.int32),
                                32, 1e4, (8, 4, 5))


def test_mrope_reduces_to_rope_on_text():
    """Equal t/h/w ids give plain RoPE's angles, and ``forward``'s text
    default (no ``positions``) is that broadcast."""
    pos = np.arange(7, dtype=np.int32)[None] + 3
    tc, ts = tattention.mrope_angles(
        torch.from_numpy(np.repeat(pos[:, None], 3, axis=1)), 32, 1e6,
        (8, 4, 4))
    rc, rs = tattention.rope_angles(torch.from_numpy(pos), 32, 1e6)
    torch.testing.assert_close(tc, rc, atol=0, rtol=0)
    torch.testing.assert_close(ts, rs, atol=0, rtol=0)
    jcfg, tcfg, jp, tp = _f32()
    toks = tokens(jcfg, 2, 10, seed=2)
    text = np.broadcast_to(np.arange(10, dtype=np.int32)[None, None],
                           (2, 3, 10)).copy()
    with torch.no_grad():
        a, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True))
        b, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True,
                                              positions=text))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_forward_with_vision_positions_matches_reference():
    jcfg, tcfg, jp, tp = _f32()
    toks = tokens(jcfg, 2, 24, seed=1)
    pos = _vision_positions(2, 24, seed=1)
    tl, jl, _, _ = forward_both(jcfg, tcfg, jp, tp,
                                {"tokens": toks, "positions": pos})
    close(tl, jl)
    # and the text default, which differs from the vision ids' logits
    td, jd, _, _ = forward_both(jcfg, tcfg, jp, tp, {"tokens": toks})
    close(td, jd)
    assert float((td - tl).abs().max()) > 1e-2
    # the stub frontend: patch embeddings in place of tokens
    emb = (0.1 * np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model))).astype(np.float32)
    te, je, _, _ = forward_both(jcfg, tcfg, jp, tp,
                                {"embeddings": emb, "positions": pos})
    close(te, je)


def test_loss_fn_gradients_match_reference():
    jcfg, tcfg, jp, tp = _f32()
    grads_match(jcfg, tcfg, jp, tp, tokens(jcfg, 2, 24, seed=4))


def test_serve_steps_match_reference_and_forward():
    jcfg, tcfg, jp, tp = _f32()
    toks = tokens(jcfg, 2, 12, seed=5)
    dec, jdec, tcache, _ = decode_both(jcfg, tcfg, jp, tp, toks, 14)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, batch(toks, torch_side=True))
    close(dec, jdec)
    close(dec, full.numpy())
    assert tcache["k"].shape == (2, 2, 14, 2, 32)


def test_serve_launcher_passes_mrope_positions(monkeypatch):
    """``launch/serve.py`` hands M-RoPE ``(B, 3, 1)`` positions, all three
    ids the shared position, as the reference's launcher."""
    from repro_torch.launch import serve as tserve

    seen = []
    make = tserve.make_serve_step

    def spy(cfg):
        step = make(cfg)

        def wrapped(p, b, cache, cache_len):
            seen.append((b["positions"].clone(), cache_len))
            return step(p, b, cache, cache_len)

        return wrapped

    monkeypatch.setattr(tserve, "make_serve_step", spy)
    cfg = tconfigs.get_smoke(ARCH)
    r = tserve.serve(cfg, tmodel.init(0, cfg, "cpu"), requests=2, batch=2,
                     max_new=3, max_len=20, device="cpu")
    assert r["done"] == 2 and seen
    for pos, n in seen:
        assert pos.shape == (2, 3, 1) and pos.dtype == torch.int32
        assert bool((pos == n).all())


def test_init_matches_reference_tree():
    init_tree_matches(*cfgs(ARCH))


def test_launchers_serve_and_train(capsys):
    out = launchers_run(ARCH, capsys)
    assert "stub frontends" in out
