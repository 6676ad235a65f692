"""The port's dataset smoke (``python -m repro_torch.data.smoke``) on the
CPU, and its loaders' one-round accuracies against the JAX package's
smoke configuration run from the same initial weights."""

import dataclasses

import jax
import pytest

from repro.fl import FLConfig as JConfig
from repro.fl import build_runner as j_build
from repro.fl.simulation import build_image_setup as j_image
from repro.fl.simulation import build_text_setup as j_text
from repro_torch.convert import from_jax_params
from repro_torch.data import smoke
from repro_torch.fl import FLConfig, build_runner
from repro_torch.fl.simulation import build_image_setup, build_text_setup
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


def test_smoke_main_on_cpu(tmp_path, capsys):
    assert smoke.main(["--device", "cpu", "--cache-dir",
                       str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1].rstrip(":") for ln in lines] == list(
        smoke.setups())
    assert all(ln.startswith("ok") and "device=cpu" in ln for ln in lines)


def test_smoke_reports_a_failing_loader(tmp_path, capsys):
    assert smoke.main(["--device", "cpu", "--scheme", "nope"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(ln.startswith("FAIL") for ln in out)


@pytest.mark.parametrize("name", ["synthetic_image", "cifar10",
                                  "synthetic_text", "shakespeare"])
def test_smoke_loader_matches_reference(name, tmp_path):
    """One cohort heroes round per loader, as the smoke runs it, from the
    reference's initial weights: accuracy within 2 test samples."""
    kind, kw = smoke.setups(cache_dir=str(tmp_path / "jax"))[name]
    jm, jx, jy, jt = (j_image if kind == "image" else j_text)(**kw)
    jr = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**smoke.CFG))
    init = jax.device_get(jm.init_factorized(jax.random.PRNGKey(0)))
    jh = jr.run(1)

    kind, kw = smoke.setups(cache_dir=str(tmp_path / "torch"))[name]
    tm, tx, ty, tt = (build_image_setup if kind == "image"
                      else build_text_setup)(device="cpu", **kw)
    with build_runner("heroes", tm, tx, ty, tt, cfg=FLConfig(**smoke.CFG),
                      device="cpu") as tr:
        tr.state = dataclasses.replace(tr.state,
                                       params=from_jax_params(init, "cpu"))
        th = tr.run(1)
    n_test = int(tt["labels"].numel())
    assert (th[0].traffic_bytes, th[0].mean_tau) == (jh[0].traffic_bytes,
                                                     jh[0].mean_tau)
    assert abs(th[0].accuracy - jh[0].accuracy) <= 2.0 / n_test
