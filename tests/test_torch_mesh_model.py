"""The port's zoo on a device mesh: a (2, 2) ("data", "model") mesh of 4
``gloo`` processes on the CPU (``tests/torch_mesh_worker.py``), each
case's params, batch and cache laid out by ``sharding.rules``, the
activation context installed, and every kernel op on its local shard
(``local_map``; on the CPU their plain versions).

Each case's forward logits (under Heroes composition also with the
composed weight built first), one AdamW train step (loss, grad norm, the
updated params and the first moment) and a prefill then 2 decode steps
are held at 1e-5 (f32, atol and rtol) to the port's one-device run and to
the reference's one-device run on the same params; xlstm-125m's against
the port's one-device run at 2e-5 (:data:`ONE_DEVICE_TOL`).  The 4
processes are spawned once for the module (~60 s; the one-device and
reference runs take as long again on one worker).
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker as W
from torch_threads import one_thread  # noqa: F401

TOL = 1e-5
# the one reading above TOL: xlstm-125m's mesh logits need 1.46e-5 against
# the port's one-device logits, which need 1.23e-5 against the reference's
# (the mesh's need 0.89e-5 against the reference's); the xLSTM's
# exponential gates amplify the order of a sum, and a contraction split
# over "model" sums in another order
ONE_DEVICE_TOL = {"xlstm-125m": 2e-5}
PARTS = {"fwd": ("logits",), "fwd_cm": ("logits_compose_matmul",),
         "train": ("loss", "grad_norm", "params", "mu"),
         "decode": ("decode",)}
CHECKS = [(W.case_name(c), key) for c in W.CASES for p in c[4]
          for key in PARTS[p]]
BY_NAME = {W.case_name(c): c for c in W.CASES}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    mp.start_processes(W.run, args=(4, str(d / "init"), str(d)), nprocs=4,
                       join=True, start_method="spawn")
    return torch.load(os.path.join(d, "mesh.pt"))


@pytest.fixture(scope="module")
def one_device_runs():
    return {W.case_name(c): W.one_device(c) for c in W.CASES}


@pytest.fixture(scope="module")
def reference_runs():
    return {W.case_name(c): W.reference(c) for c in W.CASES}


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, what, tol):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what} {k}", tol)
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("name,key", CHECKS)
def test_mesh_matches_one_device(mesh_runs, one_device_runs, name, key):
    _close(mesh_runs[name][key], one_device_runs[name][key], f"{name} {key}",
           ONE_DEVICE_TOL.get(BY_NAME[name][0], TOL))


@pytest.mark.parametrize("name,key", CHECKS)
def test_mesh_matches_reference(mesh_runs, reference_runs, name, key):
    _close(mesh_runs[name][key], reference_runs[name][key], f"{name} {key}",
           TOL)


@pytest.mark.parametrize("name", [W.case_name(c) for c in W.CASES
                                  if "train" in c[4]])
def test_optimizer_state_keeps_param_placements(mesh_runs, name):
    assert mesh_runs[name]["placements_kept"]


def test_every_case_ran_on_the_mesh(mesh_runs):
    assert set(mesh_runs) == set(BY_NAME)
