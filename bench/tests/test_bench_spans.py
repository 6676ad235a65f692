"""The readers of the program's span metrics: each is ``device_ms`` of
its span over the window's steps, from ``repro_torch.obs.spans``, and
nothing on a CPU run, without the spans, or where the totals do not
cover one ``train.forward`` a step."""

import sys

import pytest

from conftest import LM, SMOKE, cell, harness

READERS = {
    "backward_ms.train": "train.backward",
    "optimizer_ms.train": "train.optimizer",
    "recompute_ms.train": "model.layer.recompute",
    "attention_backward_ms.train": "plain_backward.flash_attention",
}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"bench_metric_test_{name.replace('.', '_')}")


def _ctx(units=4):
    return {"units": units, "trace": {"busy_s": 1.0, "window_s": 1.0,
                                      "kernels": []}}


@pytest.fixture
def registry():
    """``repro_torch.obs.spans``' registry, filled by the test and
    emptied after."""
    from repro_torch.obs import spans
    spans.reset()
    yield spans
    spans.reset()


def test_declared_for_the_lm_cell():
    c = cell(LM)
    assert set(READERS) <= {m["name"] for m in c.per_layer()}


def test_nothing_on_a_cpu_run():
    out = harness.run_cell(cell(LM), 2 ** 31 + 5, 0.5, True, "cpu",
                           overrides=SMOKE[LM])
    assert out["correct"]
    assert not set(READERS) & set(out["metrics"])


@pytest.mark.parametrize("name", sorted(READERS))
def test_device_ms_over_units(name, registry):
    calls = {"train.forward": 4, "train.backward": 4, "train.optimizer": 4,
             "model.layer": 128, "model.layer.recompute": 128,
             "plain_backward.flash_attention": 128}
    ms = {k: 10.0 * (i + 1) for i, k in enumerate(calls)}
    registry._calls.update(calls)
    registry._device_ms.update(ms)
    read = _reader(name).read
    assert read(_ctx(4)) == pytest.approx(ms[READERS[name]] / 4)
    # the totals cover other work than one forward a step
    assert read(_ctx(5)) is None
    assert read({**_ctx(4), "trace": None}) is None
    assert read({**_ctx(0)}) is None
    # the span ran on no CUDA device
    registry._device_ms.pop(READERS[name])
    assert read(_ctx(4)) is None
    # the span never ran
    registry._calls.pop(READERS[name])
    assert read(_ctx(4)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_the_spans(name, monkeypatch):
    """A version of the program that has no ``obs.spans``: the reader
    reports nothing and does not raise."""
    import repro_torch.obs as obs
    monkeypatch.delattr(obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert _reader(name).read(_ctx(4)) is None
