"""The references agree with the port at smoke size, the control (the
reference in the precision below the configuration's, in the program's
place) does not, and each fault planted in the program comes out as not
correct."""

import pytest

from conftest import LM, SMOKE, cell, harness, smoke_run


@pytest.mark.parametrize("name", [LM])
def test_program_within_limits_control_not(name):
    c, run = smoke_run(name)
    run.setup()
    run.release()
    got = run.readings()
    assert all(got[k] <= lim for k, lim in c.limits.items()), got
    low = run.control_readings()
    assert any(low[k] > lim for k, lim in c.limits.items()), low


FAULTS = [(LM, "unchanged"), (LM, "half_batch")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    """The rest of a run (no look for a chip) with the timed path broken
    underneath."""
    c = cell(name)
    with c.kind.fault(fault):
        out = harness.run_cell(c, 2 ** 31 + 5, 0.5, False, "cpu",
                               overrides=SMOKE[name])
    assert out["correct"] is False, out["checks"]


def test_departures_from_the_source_are_stated():
    """The port cannot run the published rotary share or LayerNorm
    epsilon: a configuration without its ``as_run`` values is refused."""
    c = cell(LM)
    published = {k: v for k, v in c.config.items() if k != "as_run"}
    with pytest.raises(ValueError):
        c.kind.model_config(published)
    assert c.config["partial_rotary_factor"] == 0.25
    assert c.config["as_run"]["partial_rotary_factor"] == 1.0
