"""The port's examples (``examples/*_torch.py``) on the CPU.

* quickstart's ``composition_demo`` and ``scheduler_demo`` print the
  reference example's lines, word for word (both are numpy-deterministic:
  shapes, block ids and the scheduler's plan);
* the examples that take under about 10 s on the CPU at their own size
  run their ``main`` with ``--device cpu`` (``composed_llm_training``
  with its ``--smoke``, the reference's CI size) and print only finite
  numbers; ``async_federated`` and ``federated_training`` (20–30 rounds
  of every scheme) run on the card in ``chip_smoke.py``;
* every example raises without ``--device cpu`` on a host with no CUDA
  device, before it trains anything.
"""

import importlib.util
import math
import re
from pathlib import Path

import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("quickstart", "federated_training", "async_federated",
         "federated_datasets", "composed_llm_training", "serve_decode")
NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.\d*|\d+|nan|inf)(?![\w.])",
                    re.IGNORECASE)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite(text: str) -> None:
    nums = NUMBER.findall(text)
    assert nums, text
    bad = [n for n in nums if not math.isfinite(float(n))]
    assert not bad, f"non-finite numbers {bad} in:\n{text}"


def test_quickstart_demos_print_the_reference_lines(capsys):
    ref = _load("quickstart")
    ref.composition_demo()
    ref.scheduler_demo()
    want = capsys.readouterr().out
    port = _load("quickstart_torch")
    port.composition_demo("cpu")
    port.scheduler_demo()
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert "least-trained blocks [0 1 3 5]" in got


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("federated_datasets", []),
    ("composed_llm_training", ["--smoke"]),
    ("serve_decode", []),
])
def test_example_runs_on_the_cpu(name, argv, capsys):
    _load(f"{name}_torch").main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip()
    _finite(out)


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_a_card_or_device_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the examples' default is "
                    "the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(f"{name}_torch").main([])
