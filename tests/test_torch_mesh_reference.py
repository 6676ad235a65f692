"""The port's runs over 4 logical shards against the JAX package's own
4-device runs (its ``ENGINE_SCRIPT`` and ``SHARDED_SCRIPT`` setups on 4
forced host devices).

The reference runs happen once, in one module-scoped subprocess (its
device count must be set before JAX starts), which writes each run's
initial weights, round logs and final weights to an ``.npz``.  The port
starts each run from the reference's initial weights and runs it over
``logical_devices(4, "cpu")``: round logs equal (accuracy within 2 test
samples), final weights within 1e-5.  The runs: the collective merge of
every rule and the block-split heroes state (``shard_server_state``) on
the sequential trainer, 2 rounds; the sharded cohort trainer
(``trainer="cohort"``: masked clone rows, a vmap step per shard, the
trainer's stacks handed to the merge) for fedavg, heroes and heroes with
the split state, 2 rounds; and ``SHARDED_SCRIPT``'s fastest-K
semi-async schedule on the cohort trainer for fedavg and heroes, 4
events.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.convert import from_jax_params
from repro_torch.fl import FLConfig, build_image_setup, build_runner
from repro_torch.fl.engine.collective import CohortSlice
from repro_torch.sharding import fl as flsh
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
# ENGINE_SCRIPT's schedule (8 clients at max_width 4, 2 rounds) and
# SHARDED_SCRIPT's fastest-K one (10 clients at max_width 3, 4 events)
SCHEDULES = {
    "base": (dict(num_clients=8, max_width=4),
             dict(num_clients=8, clients_per_round=3, eval_every=2,
                  tau_fixed=2, tau_max=15, estimate=True), 2),
    "async": (dict(num_clients=10, max_width=3),
              dict(num_clients=10, clients_per_round=4, eval_every=100,
                   tau_fixed=3, tau_max=15, estimate=False,
                   round_mode="semi_async", async_k=2), 4),
}
COHORT = dict(trainer="cohort")
SPLIT = dict(shard_server_state=True)
RUNS = (("base", "fedavg", {}), ("base", "heterofl", {}),
        ("base", "flanc", {}), ("base", "heroes", {}),
        ("base", "heroes", SPLIT),
        ("base", "fedavg", COHORT), ("base", "heroes", COHORT),
        ("base", "heroes", {**COHORT, **SPLIT}),
        ("async", "fedavg", COHORT), ("async", "heroes", COHORT))
LOG_KEYS = ("wall_time", "traffic_bytes", "makespan", "avg_wait",
            "mean_tau", "stale")
TOL = 1e-5

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.fl import FLConfig, build_image_setup, build_runner

    SCHEDULES, RUNS, LOG_KEYS = eval(sys.argv[2])

    def flat(tree, prefix, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f"{prefix}/{k}", out)
        else:
            out[prefix] = np.asarray(tree)

    setups = {name: build_image_setup(seed=0, **kw)
              for name, (kw, _, _) in SCHEDULES.items()}
    out = {}
    for i, (sched, scheme, knobs) in enumerate(RUNS):
        _, base, rounds = SCHEDULES[sched]
        r = build_runner(scheme, *setups[sched],
                         cfg=FLConfig(**base, **knobs))
        assert r.merger.mesh is not None
        if knobs.get("trainer") == "cohort":
            assert r.trainer.mesh.devices.size == 4
        flat(jax.device_get(r.params), f"{i}/init", out)
        logs = [r.run_round() for _ in range(rounds)]
        for key in LOG_KEYS:
            out[f"{i}/log/{key}"] = np.array([getattr(h, key)
                                              for h in logs])
        out[f"{i}/log/accuracy"] = np.array(
            [np.nan if h.accuracy is None else h.accuracy for h in logs])
        flat(jax.device_get(r.params), f"{i}/final", out)
    np.savez(sys.argv[1], **out)
    print("REFERENCE_MESH_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_ref") / "runs.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(path),
         repr((SCHEDULES, RUNS, LOG_KEYS))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REFERENCE_MESH_OK" in r.stdout
    return dict(np.load(path))


def _unflat(template, flat, prefix):
    if isinstance(template, dict):
        return {k: _unflat(v, flat, f"{prefix}/{k}")
                for k, v in template.items()}
    return flat[prefix]


@pytest.fixture(scope="module")
def setups():
    return {name: build_image_setup(seed=0, device="cpu", **kw)
            for name, (kw, _, _) in SCHEDULES.items()}


def _id(run):
    sched, scheme, knobs = run
    return "-".join([scheme] + (["cohort"] if "trainer" in knobs else [])
                    + (["split"] if "shard_server_state" in knobs else [])
                    + ([sched] if sched != "base" else []))


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[_id(r) for r in RUNS])
def test_port_mesh_run_matches_reference_mesh_run(i, reference, setups):
    sched, scheme, knobs = RUNS[i]
    _, base, rounds = SCHEDULES[sched]
    setup = setups[sched]
    with flsh.logical_devices(4, "cpu"):
        run = build_runner(scheme, *setup, cfg=FLConfig(**base, **knobs),
                           device="cpu")
    assert run.merger.mesh.size == 4
    if "trainer" in knobs:
        assert run.trainer.mesh.size == 4
    run.state = dataclasses.replace(run.state, params=from_jax_params(
        _unflat(run.params, reference, f"{i}/init"), "cpu"))
    logs = [run.run_round() for _ in range(rounds)]
    n_test = int(setup[3]["labels"].shape[0])
    for key in LOG_KEYS:
        assert [getattr(h, key) for h in logs] == \
            list(reference[f"{i}/log/{key}"]), key
    for h, want in zip(logs, reference[f"{i}/log/accuracy"]):
        assert (h.accuracy is None) == bool(np.isnan(want))
        if h.accuracy is not None:
            assert abs(h.accuracy - want) <= 2.0 / n_test
    if "trainer" in knobs:
        # no in-flight record keeps a trainer's stack alive
        assert all(not isinstance(t.result.params, CohortSlice)
                   for t in run.state.in_flight)
    if "shard_server_state" in knobs:
        assert all(isinstance(t["coeff"], flsh.SplitBlocks)
                   for t in run.params.values())
    got = flsh.assemble(run.params)
    want = _unflat(got, reference, f"{i}/final")

    def leaves(t, w):
        if isinstance(t, dict):
            for k in t:
                yield from leaves(t[k], w[k])
        else:
            yield t.numpy(), w

    for a, b in leaves(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
