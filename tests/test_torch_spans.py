"""The port's spans on the profiler's clock (``repro_torch.obs.spans``).

One step of a smoke-size Heroes-composed dense LM (stablelm-3b's smoke
widths, composition at P = 2, remat on) through ``make_train_step``:

* without a profiler no span opens a range or counts a call;
* under ``torch.profiler`` the host trace holds ``train.forward``,
  ``train.backward`` and ``train.optimizer`` once each, in that order,
  ``model.layer`` once a layer inside the forward and
  ``model.layer.recompute`` once a layer inside the backward, every span
  a ``cpu_op`` range and none a user annotation (which kineto would
  mirror onto the device's timeline); ``totals()`` counts the same calls;
* a backward through ``kernels.ops.flash_attention`` (its plain version
  on the CPU) opens ``plain_backward.flash_attention``;
* the parameters, the optimizer state and the metrics are bitwise equal
  with the profiler on and off;
* a ``Recorder``'s wall spans are also ranges under the profiler;
* a CPU step records no CUDA event once CUDA is initialised in the
  process (really, on a card; else by its check patched): a span's
  device is its work's;
* on a CUDA device (skipped without one), the spans' device times add up
  and resolve without a synchronise inside the step.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, optim
from repro_torch.configs.base import CompositionConfig
from repro_torch.core.estimator import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model
from repro_torch.obs import MemorySink, Recorder, spans

STEP_SPANS = ("train.forward", "train.backward", "train.optimizer")


def _cfg():
    cfg = configs.get_smoke("stablelm-3b").replace(remat=True)
    return cfg.replace(composition=CompositionConfig(
        enabled=True, max_width=2, rank=cfg.d_model // 4))


def _batch(cfg, device="cpu"):
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 33))
    t = torch.as_tensor(toks, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _step(traced, device="cpu", steps=1):
    """``steps`` train steps from seed 0's parameters, under a profiler
    of the CPU (and the device's) activity if ``traced``; returns the
    parameters, the optimizer state, the last metrics and the profile."""
    cfg = _cfg()
    params = model.init(0, cfg, device)
    opt = optim.make_optimizer("adamw", optim.cosine_schedule(3e-3, 10, 2))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = _batch(cfg, device)
    spans.reset()
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
    if prof is not None:
        prof.__exit__(None, None, None)
    return params, state, metrics, prof


def _ranges(prof, prefixes=("train.", "model.", "plain_backward.")):
    """``name -> [(start_ns, end_ns)]`` of the trace's events whose names
    start with one of ``prefixes``."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(prefixes):
            out.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def _kinds(prof, path, names):
    """``name -> {category}`` of the events named ``names`` in the
    profile's Chrome trace (``cpu_op``, ``user_annotation``,
    ``gpu_user_annotation``, ...)."""
    prof.export_chrome_trace(str(path))
    out = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        if ev.get("name") in names:
            out.setdefault(ev["name"], set()).add(ev.get("cat"))
    return out


class _Counting:
    """Stands in for ``_RecordFunctionFast``, counting the ranges opened."""

    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_profiler_no_range(monkeypatch):
    monkeypatch.setattr(spans, "_RecordFunctionFast", _Counting)
    _Counting.opened = 0
    _step(traced=False)
    assert _Counting.opened == 0
    assert spans.totals() == {}
    assert spans.span("train.forward", None) is spans.span("model.layer",
                                                             "cpu")
    # the same patch sees every span once a profiler records
    _step(traced=True)
    n = _cfg().num_layers
    assert _Counting.opened == 3 + 2 * n


def test_step_spans_under_the_profiler(tmp_path):
    n = _cfg().num_layers
    *_, prof = _step(traced=True)
    got = _ranges(prof)
    assert set(got) == {*STEP_SPANS, "model.layer", "model.layer.recompute"}
    assert _kinds(prof, tmp_path / "t.json", set(got)) == {
        k: {"cpu_op"} for k in got}
    (fwd,), (bwd,), (opt,) = (got[k] for k in STEP_SPANS)
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    assert len(got["model.layer"]) == n
    assert all(fwd[0] <= s and e <= fwd[1] for s, e in got["model.layer"])
    assert len(got["model.layer.recompute"]) == n
    assert all(bwd[0] <= s and e <= bwd[1]
               for s, e in got["model.layer.recompute"])
    tot = spans.totals()
    assert {k: v["calls"] for k, v in tot.items()} == {
        **{k: 1 for k in STEP_SPANS}, "model.layer": n,
        "model.layer.recompute": n}
    # on the CPU a span has calls and no device time
    assert all(v["device_ms"] is None for v in tot.values())


def test_plain_backward_span(tmp_path):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 2, 1, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    out = ops.flash_attention(q, k, v)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out.square().sum().backward()
    name = "plain_backward.flash_attention"
    assert list(_ranges(prof)) == [name]
    assert _kinds(prof, tmp_path / "t.json", {name}) == {name: {"cpu_op"}}
    assert spans.totals() == {name: {"calls": 1, "device_ms": None}}
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_attention_backward_span_once_a_layer(monkeypatch):
    """A step whose attention runs through ``kernels.ops`` (as on a card;
    on the CPU its plain version) opens ``plain_backward.flash_attention``
    once a layer, inside the backward, whichever backward computes it."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)
    n = _cfg().num_layers
    *_, prof = _step(traced=True)
    got = _ranges(prof)
    name = "plain_backward.flash_attention"
    (bwd,) = got["train.backward"]
    assert len(got[name]) == n
    assert all(bwd[0] <= s and e <= bwd[1] for s, e in got[name])
    assert spans.totals()[name]["calls"] == n


def test_profiler_changes_no_number():
    p0, s0, m0, _ = _step(traced=False)
    p1, s1, m1, _ = _step(traced=True)
    for a, b in zip(tree_leaves(p0) + tree_leaves(s0),
                    tree_leaves(p1) + tree_leaves(s1)):
        assert torch.equal(a, b)
    assert set(m0) == set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_recorder_wall_spans_are_ranges(tmp_path):
    sink = MemorySink()
    rec = Recorder([sink])
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.wall_span("aggregate.merge", clients=4):
            with rec.wall_span("checkpoint.save"):
                torch.ones(8).sum()
    names = ("aggregate.merge", "checkpoint.save")
    got = _ranges(prof, names)
    (merge,), (save,) = (got[k] for k in names)
    assert merge[0] <= save[0] and save[1] <= merge[1]
    assert _kinds(prof, tmp_path / "t.json", set(names)) == {
        k: {"cpu_op"} for k in names}
    assert [s["name"] for s in sink.spans()] == ["checkpoint.save",
                                                 "aggregate.merge"]
    assert {k: v["calls"] for k, v in spans.totals().items()} == {
        "aggregate.merge": 1, "checkpoint.save": 1}
    # off the profiler the recorder's stream is as it was, and no span
    spans.reset()
    with rec.wall_span("aggregate.merge"):
        pass
    assert len(sink.spans("aggregate.merge")) == 2
    assert spans.totals() == {}


@pytest.mark.parametrize("cuda", ["patched", "initialised"])
def test_cpu_step_after_cuda_init(cuda, monkeypatch):
    if cuda == "initialised":
        if not torch.cuda.is_available():
            pytest.skip("initialising CUDA takes a card")
        torch.ones(1, device="cuda")
        assert torch.cuda.is_initialized()
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    made, event = [], torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(a) or event(*a, **k))
    _step(traced=True)
    tot = spans.totals()
    assert tot["train.forward"]["calls"] == 1
    assert tot["model.layer.recompute"]["calls"] == _cfg().num_layers
    assert all(v["device_ms"] is None for v in tot.values())
    assert made == []


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="device time is taken by CUDA events on a card")
def test_device_time_on_the_card():
    n = _cfg().num_layers
    *_, prof = _step(traced=True, device="cuda", steps=2)
    tot = spans.totals()
    assert tot["train.forward"]["calls"] == 2
    assert tot["model.layer.recompute"]["calls"] == 2 * n
    ms = {k: v["device_ms"] for k, v in tot.items()}
    assert all(t is not None and t > 0 for t in ms.values()), ms
    # nested spans are inclusive
    assert ms["model.layer"] <= ms["train.forward"]
    assert ms["model.layer.recompute"] <= ms["train.backward"]
    # the spans are host ranges: none lands on the device's timeline
    from torch.autograd import DeviceType
    assert not [ev.name() for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == DeviceType.CUDA and
                ev.name().startswith(("train.", "model.", "plain_backward."))]
