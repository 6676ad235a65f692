"""Shared set-up of the benchmark's CPU tests: the harness on the path,
the cells at smoke size, and the ``chip`` marker for the tests that need
a CUDA device (they decide inside the test, and skip here)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

import run as harness  # noqa: E402

LM = "stablelm-3b-heroes.train-4k"
# smoke sizes: every width of the configuration kept small enough for a
# CPU test
SMOKE = {
    LM: {"config": {"num_hidden_layers": 2, "hidden_size": 256,
                    "num_attention_heads": 8, "num_key_value_heads": 8,
                    "intermediate_size": 512, "vocab_size": 512,
                    "heroes_composition": {"max_width": 2, "rank": 64,
                                           "width": 2}},
         "traffic": {"batch": 2, "seq": 64}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device")


def cell(name, root=harness.ROOT):
    return harness.Cell(harness.read_json(root / "BENCHMARK.json"), name,
                        root)


def smoke_run(name, cfg_over=None, **kw):
    """The kind's run object of cell ``name`` at smoke size on the CPU."""
    c = cell(name)
    cfg = {**c.config, **SMOKE[name]["config"], **(cfg_over or {})}
    tr = {**c.traffic, **SMOKE[name]["traffic"]}
    return c, c.kind.make(cfg, tr, kw.get("seed", 7), "cpu", False,
                            c.reference)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
