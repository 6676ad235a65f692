"""Each cell runs end to end at smoke size on the CPU and prints the
result line; without a CUDA device the command prints nothing
and fails."""

import json

import pytest

from conftest import LM, SMOKE, cell, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", [LM])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_at_smoke_size(name, trace):
    c = cell(name)
    out = harness.run_cell(c, 2 ** 31 + 11, 1.0, trace, "cpu",
                           overrides=SMOKE[name])
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    json.dumps(out)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(c.limits)
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end()}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        # a CPU run writes no device metric, and no device operation
        assert not out["metrics"] or all(
            "mfu" not in k and "roofline" not in k and "idle" not in k
            for k in out["metrics"])
        assert out["breakdown"]["device_ops"] == []


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", LM, "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


@pytest.mark.chip
@pytest.mark.parametrize("name", [LM])
def test_cell_on_the_card(name):
    """The command on the card, as the check runs it, for a short window."""
    import subprocess
    import sys

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                        "--seed", "3000000001", "--seconds", "3",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
