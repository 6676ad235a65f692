"""The port's telemetry (``repro_torch.obs`` and the engine's spans and
counters) against the JAX package's ``repro.obs``.

(a) Every unit of the toolkit takes the same inputs as the reference's
function and must give equal output (the report may differ only in its
provenance line).  (b) A log written by either package validates and
renders in the other.  (c) Telemetry changes no port result: every
scheme in both round modes gives the same history and weights, bit for
bit, with it on and off.  (d) A port run's event stream equals the
reference's: both engines start from the reference's weights (carried
across with ``from_jax_params``) and draw the same minibatches, so the
virtual-clock spans and events, the traffic, participation, merge and
coverage counters, staleness and the round histograms are the
reference's, and the wall spans have the reference's names and counts.
(e) The cohort trainer's spans and its ``trainer.cohort_shape`` counter
against the reference's (the port pads neither clients nor τ and has no
``trainer.jit_recompiles``).  (f) Checkpoints are spanned and counted,
and a resumed run with telemetry on equals the uninterrupted one.
(g) The telemetry smoke passes on the CPU.  Each reference run is made
once per module and shared.
"""

import collections
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.fl import FLConfig as JConfig
from repro.fl import build_image_setup as j_setup
from repro.fl import build_runner as j_build
from repro.obs.report import render_report as j_render
from repro.obs.schema import validate_event as j_validate_event
from repro.obs.schema import validate_file as j_validate_file
import repro_torch.obs as tobs
from repro_torch.convert import from_jax_params
from repro_torch.core.estimator import tree_leaves
from repro_torch.fl import FLConfig, build_image_setup, build_runner
from repro_torch.fl import build_setup
from repro_torch.obs.report import render_report as t_render
from repro_torch.obs.report import split_key
from repro_torch.obs.schema import validate_event as t_validate_event
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SCHEMES = ("fedavg", "adp", "heterofl", "flanc", "heroes")
MODES = ("sync", "semi_async")
ROUNDS = 3
# the JAX package's telemetry smoke configuration, materialize
BASE = dict(num_clients=10, clients_per_round=4, eval_every=2, tau_fixed=4,
            tau_max=15, estimate=True, forward_impl="materialize")
ASYNC = dict(async_k=2)
# virtual-clock times: the same float operations in the same order
TIME_RTOL = 1e-9
# counters whose values the two packages must share, by name prefix
SHARED = ("traffic.", "participation.tier", "aggregate.collective_calls",
          "coverage.")


def _kw(mode, **kw):
    return dict(BASE, round_mode=mode, **(ASYNC if mode == "semi_async"
                                          else {}), **kw)


def _history(runner):
    return [dataclasses.asdict(h) for h in runner.history]


def _same_params(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _events(runner):
    return runner.obs.sinks[0].events


@pytest.fixture(scope="module")
def setups():
    return (j_setup(num_clients=10, seed=0),
            build_image_setup(num_clients=10, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def reference(setups):
    """``run(scheme, mode, rounds, **knobs)`` -> (initial params as
    numpy, the reference's events with ``telemetry="memory"``, its
    history), each run once."""
    cache = {}

    def run(scheme, mode, rounds=ROUNDS, **kw):
        key = (scheme, mode, rounds, tuple(sorted(kw.items())))
        if key not in cache:
            jr = j_build(scheme, *setups[0], cfg=JConfig(**_kw(
                mode, telemetry="memory", **kw)))
            init = jax.device_get(jr.params)
            with jr:
                hist = jr.run(rounds)
            cache[key] = (init, jr.obs.sinks[0].events, hist)
        return cache[key]

    return run


def _port(setups, scheme, mode, init=None, rounds=ROUNDS, **kw):
    """A closed port runner after ``rounds`` rounds from ``init``."""
    with build_runner(scheme, *setups[1], device="cpu",
                      cfg=FLConfig(**_kw(mode, **kw))) as r:
        if init is not None:
            r.state = dataclasses.replace(
                r.state, params=from_jax_params(init, "cpu"))
        r.run(rounds)
    return r


# ---------------------------------------------------------------------------
# (a) units against the reference's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,labels", [
    ("traffic.up", {}), ("traffic.up", {"width": 2}),
    ("x", {"b": 1, "a": 2}), ("trainer.cohort_shape",
                              {"width": 3, "clients": 4, "tau_pad": 1,
                               "batch": 16}),
])
def test_metric_key_matches_reference(name, labels):
    assert tobs.metric_key(name, labels) == jobs.metric_key(name, labels)


def _script(rec):
    """The same registry operations on either package's recorder."""
    rec.counter_add("c", 2.0)
    rec.counter_add("c", 3.0)
    rec.counter_add("c", 1.0, width=1)
    rec.gauge_set("g", 7.0)
    rec.gauge_set("g", 9.0, tier="tx2")
    rec.observe("h", 0.5)
    rec.observe("h", 1.5)
    rec.tally_add("cov", [0, 2, 2], 1)
    rec.tally_add("cov", [5], 3)  # grows the dense array
    rec.tally_add("cov", [0, 1], np.array([10, 20]))  # per-id amounts
    rec.tally_add("cov", [])  # no ids: no change
    rec.tally_add("other", np.int64(4), 0)
    rec.span("client.train", 1.0, 3.5, client=4)
    rec.event("round.aggregate", 3.5, round=0)
    rec.span("aggregate.merge", 0.25, 0.5, clock="wall", clients=4)
    return rec


def test_registry_snapshot_and_tallies_match_reference():
    tsink, jsink = tobs.MemorySink(), jobs.MemorySink()
    t = _script(tobs.Recorder([tsink], meta={"scheme": "heroes"}))
    j = _script(jobs.Recorder([jsink], meta={"scheme": "heroes"}))
    assert t.snapshot() == j.snapshot()
    t.close()
    j.close()
    t.close()  # idempotent: one snapshot only
    assert tsink.events == jsink.events
    assert tsink.metrics == jsink.metrics
    assert tsink.spans("client.train") == jsink.spans("client.train")
    with t.wall_span("checkpoint.save", round=1):
        pass
    assert len(t.histograms["checkpoint.save_s"]) == 1


def test_noop_and_build_recorder_modes(tmp_path):
    assert tobs.NOOP.enabled is False
    assert isinstance(tobs.NOOP, tobs.NoopRecorder)
    _script(tobs.NOOP)
    with tobs.NOOP.wall_span("w"):
        pass
    assert tobs.NOOP.snapshot() == jobs.NOOP.snapshot()
    assert tobs.build_recorder(FLConfig()) is tobs.NOOP
    rec = tobs.build_recorder(FLConfig(telemetry="memory"),
                              meta={"scheme": "x"}, device="cpu")
    assert rec.enabled and isinstance(rec.sinks[0], tobs.MemorySink)
    prov = rec.sinks[0].events[0]["provenance"]
    assert prov["torch"] == torch.__version__
    assert (prov["device_kind"], prov["device_count"]) == ("cpu", 1)
    for bad, match in ((dict(telemetry="jsonl"), "telemetry_dir"),
                       (dict(telemetry="bogus"), "unknown telemetry")):
        with pytest.raises(ValueError, match=match) as te:
            tobs.build_recorder(FLConfig(**bad))
        with pytest.raises(ValueError) as je:
            jobs.build_recorder(JConfig(**bad))
        assert str(te.value) == str(je.value)
    rec = tobs.build_recorder(FLConfig(telemetry="jsonl",
                                       telemetry_dir=str(tmp_path)))
    rec.close()
    assert tobs.validate_file(tmp_path / "events.jsonl") == \
        {"meta": 1, "metrics": 1}


GOOD = [{"type": "meta", "schema": 1, "scheme": "heroes"},
        {"type": "span", "name": "s", "clock": "wall", "t0": 0.0,
         "t1": 1.0, "attrs": {}},
        {"type": "event", "name": "e", "clock": "virtual", "t": 2,
         "attrs": {"round": 1}},
        {"type": "metrics", "counters": {"c": 1.0}, "gauges": {},
         "histograms": {"h": [1.0]}, "tallies": {"t": [0, 1]}}]


@pytest.mark.parametrize("events", [
    [],
    GOOD[1:],  # no meta header
    [{"type": "meta", "schema": 2}],
    GOOD[:1] + [{"type": "span", "name": "x"}],
    GOOD[:1] + [dict(GOOD[1], clock="lunar")],
    GOOD[:1] + [dict(GOOD[1], t0=2.0)],
    GOOD[:1] + [dict(GOOD[1], attrs=[])],
    GOOD[:1] + [dict(GOOD[2], t="0")],
    GOOD[:1] + [dict(GOOD[3], counters={"c": True})],
    GOOD[:1] + [dict(GOOD[3], tallies={"t": [0, "1"]})],
    GOOD[:1] + [GOOD[3], GOOD[3]],
    GOOD[:1] + [GOOD[3], GOOD[1]],
    GOOD[:1] + [{"type": "blob"}],
])
def test_validate_rejects_malformed_logs_as_reference(events):
    with pytest.raises(ValueError) as te:
        tobs.validate_events(events)
    with pytest.raises(ValueError) as je:
        jobs.validate_events(events)
    assert str(te.value) == str(je.value)


def test_validate_good_log_load_torn_tail_and_trace(tmp_path):
    assert tobs.validate_events(GOOD) == jobs.validate_events(GOOD)
    for i, e in enumerate(GOOD):
        t_validate_event(e, i)
        j_validate_event(e, i)
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in GOOD)
                    + '{"type": "spa')
    assert tobs.load_events(path) == jobs.load_events(path) == GOOD
    assert tobs.to_trace_events(GOOD) == jobs.to_trace_events(GOOD)


@pytest.mark.parametrize("metrics", [
    {"counters": {"coverage.events": 4.0},
     "tallies": {"coverage.hidden_rounds": [4, 2, 0],
                 "coverage.hidden_iters": [40, 20, 0],
                 "coverage.anchored_rounds": [3, 1]}},
    {"counters": {}, "tallies": {"coverage.hidden_rounds": [0, 0]}},
    {"counters": {}, "tallies": {}},
])
def test_coverage_table_matches_reference(metrics):
    table = tobs.coverage_table(metrics)
    assert table == jobs.coverage_table(metrics)
    assert tobs.format_coverage(table) == jobs.format_coverage(table)


def _reports_agree(events):
    """The two reports of one log: equal but for the provenance line."""
    t, j = t_render(events).splitlines(), j_render(events).splitlines()
    assert len(t) == len(j)
    assert t[:1] + t[2:] == j[:1] + j[2:]
    return t


def test_report_and_trace_of_a_port_run_match_reference(setups):
    r = _port(setups, "heroes", "semi_async", rounds=2, telemetry="memory")
    events = _events(r)
    lines = _reports_agree(events)
    assert lines[1].startswith(f"   torch {torch.__version__} on 1x cpu")
    assert tobs.to_trace_events(events) == jobs.to_trace_events(events)
    _reports_agree(events[:-1])  # a killed run: no metrics snapshot


# ---------------------------------------------------------------------------
# (b) logs of either package read in the other
# ---------------------------------------------------------------------------


def test_logs_cross_read(setups, reference, tmp_path):
    _port(setups, "heroes", "sync", rounds=2, telemetry="jsonl",
          telemetry_dir=str(tmp_path / "port"))
    port_log = tmp_path / "port" / "events.jsonl"
    counts = j_validate_file(port_log)
    assert counts == tobs.validate_file(port_log)
    assert counts["metrics"] == 1 and counts["span"] > 0
    _reports_agree(jobs.load_events(port_log))

    _, ref_events, _ = reference("heroes", "sync")
    ref_log = tmp_path / "ref" / "events.jsonl"
    sink = jobs.JsonlSink(ref_log)
    for e in ref_events:
        sink.emit(e)
    sink.close()
    events = tobs.load_events(ref_log)
    assert tobs.validate_file(ref_log) == jobs.validate_file(ref_log)
    assert t_render(events) == j_render(events)
    tobs.export_trace(events, tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == \
        json.loads(json.dumps(jobs.to_trace_events(events)))


def test_report_and_trace_clis_match_reference(setups, tmp_path, capsys):
    from repro.obs import report as j_report
    from repro.obs import trace as j_trace
    from repro_torch.obs import report as t_report
    from repro_torch.obs import trace as t_trace

    _port(setups, "fedavg", "semi_async", rounds=2, telemetry="jsonl",
          telemetry_dir=str(tmp_path))
    log = str(tmp_path / "events.jsonl")
    out = {}
    for name, report, trace in (("t", t_report, t_trace),
                                ("j", j_report, j_trace)):
        d = tmp_path / name
        d.mkdir()
        assert report.main([log, "--trace", str(d / "1.json")]) == 0
        assert trace.main([log, str(d / "2.json")]) == 0
        out[name] = capsys.readouterr().out.replace(str(d), "D")
    t, j = out["t"].splitlines(), out["j"].splitlines()
    assert t[:1] + t[2:] == j[:1] + j[2:]
    for k in (1, 2):
        assert (tmp_path / "t" / f"{k}.json").read_text() == \
            (tmp_path / "j" / f"{k}.json").read_text()


# ---------------------------------------------------------------------------
# (c) telemetry changes no port result
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_telemetry_leaves_port_runs_unchanged(setups, scheme, mode):
    off = _port(setups, scheme, mode)
    assert off.obs is tobs.NOOP
    dispatched = []
    with build_runner(scheme, *setups[1], device="cpu",
                      cfg=FLConfig(**_kw(mode, telemetry="memory"))) as on:
        train_all = on.trainer.train_all

        def counted(state, assigns):
            dispatched.extend(int(n) for n in assigns)
            return train_all(state, assigns)

        on.trainer.train_all = counted
        on.run(ROUNDS)
    assert _history(on) == _history(off)
    assert _same_params(on.params, off.params)
    sink = on.obs.sinks[0]
    for name in ("client.train", "client.upload"):
        assert [s["attrs"]["client"] for s in sink.spans(name)] == dispatched
    counters = sink.metrics["counters"]
    up = sum(v for k, v in counters.items() if k.startswith("traffic.up["))
    down = sum(v for k, v in counters.items()
               if k.startswith("traffic.down["))
    assert up == down == pytest.approx(sum(h.up_bytes for h in on.history),
                                       rel=1e-12)
    assert up + down == pytest.approx(on.history[-1].traffic_bytes,
                                      rel=1e-12)
    assert sum(v for k, v in counters.items()
               if k.startswith("participation.tier[")) == len(dispatched)
    assert len(sink.spans("aggregate.merge")) == ROUNDS


def test_population_tier_counter_reads_the_virtual_profiles():
    """A million virtual clients: the tier counter reads the sampled
    clients' profiles from the registry, nothing per client else."""
    setup = build_setup("synthetic_image", seed=0, population=1_000_000,
                        partition_kw={"samples_per_client": 32},
                        device="cpu")
    with build_runner("fedavg", *setup, device="cpu", cfg=FLConfig(
            num_clients=1_000_000, clients_per_round=3, tau_fixed=1,
            forward_impl="materialize", telemetry="memory")) as r:
        r.run(1)
    want = collections.Counter(
        f"participation.tier[tier={r.population.profile(n).tier}]"
        for n in r.state.participation)
    got = {k: v for k, v in r.obs.counters.items()
           if k.startswith("participation.tier")}
    assert got == dict(want) and sum(got.values()) == 3


# ---------------------------------------------------------------------------
# (d), (e) the event stream against the reference's
# ---------------------------------------------------------------------------


def _virtual(events):
    return [e for e in events if e.get("clock") == "virtual"]


def _wall_names(events):
    return collections.Counter(e["name"] for e in events
                               if e.get("type") == "span"
                               and e["clock"] == "wall")


def _assert_stream_matches(t_events, j_events):
    tv, jv = _virtual(t_events), _virtual(j_events)
    assert len(tv) == len(jv) > 0
    for a, b in zip(tv, jv):
        assert (a["type"], a["name"], a["attrs"]) == \
            (b["type"], b["name"], b["attrs"])
        for k in ("t0", "t1", "t"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=TIME_RTOL, abs=0)
    tm, jm = t_events[-1], j_events[-1]
    assert tm["type"] == jm["type"] == "metrics"
    assert t_events[0]["config"] == j_events[0]["config"]
    shared = {k: v for k, v in jm["counters"].items()
              if k.startswith(SHARED)}
    assert {k: v for k, v in tm["counters"].items()
            if k.startswith(SHARED)} == shared
    assert shared and any(k.startswith("aggregate.collective_calls")
                          for k in shared)
    # the port's counters: the reference's less its recompile counts
    assert not any(k.startswith("trainer.jit_recompiles")
                   for k in tm["counters"])
    assert set(tm["counters"]) == {
        k for k in jm["counters"]
        if not k.startswith("trainer.jit_recompiles")}
    assert tm["tallies"] == jm["tallies"]
    assert tm["gauges"] == jm["gauges"]
    th, jh = tm["histograms"], jm["histograms"]
    assert set(th) == set(jh)
    assert th.get("staleness") == jh.get("staleness")
    for k in ("round.makespan", "round.wait"):
        np.testing.assert_allclose(th[k], jh[k], rtol=TIME_RTOL, atol=0)
    for k in th:
        assert len(th[k]) == len(jh[k]), k
    assert _wall_names(t_events) == _wall_names(j_events)


@pytest.mark.parametrize("scheme,mode", [
    ("heroes", "sync"), ("heroes", "semi_async"),
    ("fedavg", "semi_async"), ("flanc", "sync"),
])
def test_event_stream_matches_reference(setups, reference, scheme, mode):
    init, j_events, _ = reference(scheme, mode)
    r = _port(setups, scheme, mode, init=init, telemetry="memory")
    _assert_stream_matches(_events(r), j_events)
    if mode == "semi_async":
        assert any(s > 0 for s in r.obs.histograms["staleness"])


# two rounds, so the second's groups differ in size and τ; no estimates,
# whose batched functions would add compiles to the reference's run
COHORT = dict(trainer="cohort", estimate=False)
COHORT_ROUNDS = 2


def test_cohort_spans_match_reference(setups, reference):
    init, j_events, _ = reference("heroes", "sync", COHORT_ROUNDS, **COHORT)
    r = _port(setups, "heroes", "sync", init=init, rounds=COHORT_ROUNDS,
              telemetry="memory", **COHORT)
    t_events = _events(r)
    tv, jv = _virtual(t_events), _virtual(j_events)
    assert [(e["name"], e["attrs"]) for e in tv] == \
        [(e["name"], e["attrs"]) for e in jv]
    assert _wall_names(t_events) == _wall_names(j_events)
    tsink = r.obs.sinks[0]
    jsteps = [s["attrs"] for s in j_events if s.get("type") == "span"
              and s["name"] == "trainer.device_step"]
    tsteps = [s["attrs"] for s in tsink.spans("trainer.device_step")]
    assert len(tsteps) == len(jsteps) > 0
    for t, j in zip(tsteps, jsteps):
        assert t["width"] == j["width"]
        assert t["clients"] <= j["clients"] and t["tau_pad"] <= j["tau_pad"]
    # the port's groups are unpadded: round 2 trains 3 clients where the
    # reference pads to 4
    assert any(t["clients"] < j["clients"] for t, j in zip(tsteps, jsteps))
    # one cohort_shape count per group, labelled as its device step and
    # its host batches; width and batch as the reference's
    hsteps = [s["attrs"] for s in tsink.spans("trainer.host_stage")]
    assert len(hsteps) == len(tsteps)
    shapes = {k: v for k, v in r.obs.counters.items()
              if k.startswith("trainer.cohort_shape")}
    assert shapes == dict(collections.Counter(
        tobs.metric_key("trainer.cohort_shape", dict(t, batch=h["batch"]))
        for t, h in zip(tsteps, hsteps)))

    def width_batch(counters):
        return {(lb["width"], lb["batch"]) for lb in
                (split_key(k)[1] for k in counters
                 if k.startswith("trainer.cohort_shape"))}

    assert width_batch(shapes) == width_batch(j_events[-1]["counters"])
    assert not any(k.startswith("trainer.jit_recompiles")
                   for k in r.obs.counters)
    assert "data.prefetch_depth" in r.obs.histograms
    assert len(tsink.spans("trainer.host_stage")) == len(tsteps)
    text = t_render(t_events)
    assert (f"train-step recompiles: 0 over {len(shapes)} distinct cohort "
            "shapes") in text


# ---------------------------------------------------------------------------
# (f) checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_spanned_counted_and_resumed(setups, mode, tmp_path):
    def cfg(d):
        return dict(checkpoint_every=1, checkpoint_dir=str(d),
                    telemetry="memory")

    full = _port(setups, "heroes", mode, **cfg(tmp_path / "full"))
    sink = full.obs.sinks[0]
    assert len(sink.spans("checkpoint.save")) == ROUNDS
    assert [s["attrs"]["round"] for s in sink.spans("checkpoint.save")] == \
        list(range(1, ROUNDS + 1))
    assert full.obs.counters["checkpoint.saves"] == ROUNDS
    on_disk = sum(f.stat().st_size
                  for f in (tmp_path / "full").glob("step_*/*"))
    assert full.obs.counters["checkpoint.bytes"] == on_disk
    assert "checkpoints: 3 saves" in t_render(sink.events)

    _port(setups, "heroes", mode, rounds=ROUNDS - 1, **cfg(tmp_path / "run"))
    with build_runner("heroes", *setups[1], device="cpu", cfg=FLConfig(
            **_kw(mode, **cfg(tmp_path / "run")))) as resumed:
        assert resumed.restore_latest()
        if mode == "semi_async":
            assert resumed.state.in_flight
        resumed.run(1)
        resumed.close()  # and again on leaving the block
    assert _history(resumed) == _history(full)
    assert _same_params(resumed.params, full.params)
    assert sum(e["type"] == "metrics" for e in _events(resumed)) == 1


# ---------------------------------------------------------------------------
# (g) the smoke
# ---------------------------------------------------------------------------


def test_obs_smoke_on_the_cpu(tmp_path, capsys):
    from repro_torch.obs import smoke

    if not torch.cuda.is_available():  # the card or nothing, by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smoke.main(["--out-dir", str(tmp_path / "none")])
    assert smoke.main(["--device", "cpu", "--rounds", "2",
                       "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("history parity OK") == len(smoke.RUNS)
    for run in smoke.RUNS:
        path = tmp_path / f"{run['scheme']}_{run['round_mode']}"
        assert (path / "trace.json").exists()
        assert j_validate_file(path / "events.jsonl")["metrics"] == 1
