"""An autouse fixture the port's test modules share: each that drives
engine runs imports it (``from torch_threads import one_thread  # noqa:
F401``), which applies it to that module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These runs are chains of tiny ops: one intra-op thread runs them
    faster than many, and keeps a loaded machine's workers from
    oversubscribing its cores.  Restored for the worker's next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
