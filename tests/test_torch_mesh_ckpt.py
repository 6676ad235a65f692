"""Checkpoints of a run laid out on a device mesh: the codec's collective
save and its restore into a layout (``checkpoint/msgpack_ckpt.py``), and
``launch/train.py --mesh pod|multipod --ckpt-dir``.

* **The slicing rule**, in fake worlds of 4, 256 and 512 ranks on the
  CPU, for a dim over two mesh axes, a dim over one, an uneven split
  (empty shards), a replicated leaf, a 0-d int32 and a bf16 leaf: rank
  0's save puts its shard at its block of the file, and the restore of
  the file into the layout, on rank 0 and on three other ranks, is
  ``distribute_tensor(whole, mesh, placements,
  src_data_rank=None).to_local()`` bit for bit.
* **Real gloo runs**: 4 processes on a (2, 2) mesh run the launcher's
  ``main`` on gemma-2b's smoke config in f32
  (``tests/torch_mesh_ckpt_worker.py``).  A run resumed from its step-2
  checkpoint in new processes writes at step 4 the uninterrupted run's
  file, byte for byte (the same reductions in the same order: bit for
  bit); the freshly laid-out state saves as the one-device port's file,
  byte for byte; the reference's step-2 checkpoint (its ``adamw``,
  ``make_train_step`` and ``save_checkpoint``, as
  ``tests/test_torch_interop.py`` makes it) restores into every rank's
  shards bit for bit, continues to the reference's losses and f64
  gradient norms at ``tests/test_torch_launchers.py``'s 1e-5, and the
  mesh's step-4 file loads in the reference's ``load_checkpoint`` with
  its every path, dtype and shape.  The processes are spawned twice
  for the module (~40 s, with the reference's 4 steps).
* **The pod mesh**: ``main(["--mesh", "pod", "--smoke", "--ckpt-dir",
  ...])`` twice as rank 0 of a fake world of 256: its file's header is
  the one-device run's, rank 0's block of each leaf is its shard at the
  save, the second call resumes, and its restored shards are the file's.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

import torch_mesh_ckpt_worker as W
from repro import configs as jconfigs
from repro import optim as joptim
from repro.checkpoint import msgpack_ckpt as jckpt
from repro.data import SyntheticTextTask as JTextTask
from repro.data import lm_batches as j_lm_batches
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.core.estimator import tree_map
from repro_torch.launch import train as ttrain
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import model as tmodel
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.sharding import rules
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

# world: (mesh shape, axis names)
WORLDS = {4: ((2, 2), ("data", "model")),
          256: ((16, 16), ("data", "model")),
          512: ((2, 16, 16), ("pod", "data", "model"))}
# leaf: (shape, dtype, spec on ("data", "model"), on ("pod", "data", "model"))
LEAVES = {
    "two_axes": ((512, 32), torch.float32, (("data", "model"), None),
                 (("pod", "data"), "model")),
    "shard": ((48, 32), torch.float32, ("model", "data"), ("model", "data")),
    "uneven": ((36, 20), torch.float32, ("data", "model"),
               ("data", "model")),
    "replicate": ((8, 6), torch.float32, (None, None), (None, None)),
    "scalar": ((), torch.int32, (), ()),
    "bf16": ((32, 48), torch.bfloat16, ("data", "model"), ("pod", "model")),
}
CASES = [(w, k) for w in WORLDS for k in LEAVES]


def _whole(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * 100
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _region(t, shape, offset):
    return torch.as_tensor(t)[tuple(slice(o, o + n)
                                    for o, n in zip(offset, shape))]


def _restores_as_distribute_tensor(saved, like, mesh, placements):
    got = tckpt.local_shard(saved, like)
    want = distribute_tensor(torch.as_tensor(saved).clone(), mesh,
                             placements, src_data_rank=None).to_local()
    assert W.same_bits(got.to_local(), want)
    assert got.placements == tuple(placements)
    assert tuple(got.shape) == tuple(like.shape)


@pytest.mark.parametrize("world,kind", CASES,
                         ids=[f"{w}-{k}" for w, k in CASES])
def test_mesh_save_and_restore_slices(tmp_path, world, kind):
    shape, dtype, spec2, spec3 = LEAVES[kind]
    mesh_shape, names = WORLDS[world]
    spec = rules.Spec(*(spec3 if len(mesh_shape) == 3 else spec2))
    whole = _whole(shape, dtype)
    with fake_world(world):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
        placements = rules.to_placements(spec, mesh)
        leaf = distribute_tensor(whole, mesh, placements, src_data_rank=None)
        tckpt.save_checkpoint(tmp_path, 1, {"leaf": leaf})
        saved = tckpt.load_checkpoint(tmp_path / "step_00000001")["leaf"]
        assert torch.as_tensor(saved).dtype == dtype
        assert tuple(saved.shape) == shape
        # rank 0's block of the file is its shard (the rest of the file is
        # what the fake world's recvs left unfilled)
        lshape, offset = compute_local_shape_and_global_offset(
            shape, mesh, placements)
        assert W.same_bits(_region(saved, lshape, offset), leaf.to_local())
        if kind in ("replicate", "scalar"):  # rank 0 holds it whole
            assert W.same_bits(saved, whole)
        _restores_as_distribute_tensor(saved, leaf, mesh, placements)
    for rank in (1, world // 2 + 1, world - 1):
        with fake_world(world, rank):
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
            like = distribute_tensor(torch.zeros(shape, dtype=dtype), mesh,
                                     placements, src_data_rank=None)
            _restores_as_distribute_tensor(saved, like, mesh, placements)


def test_one_device_restore_keeps_the_whole_leaf():
    leaf = _whole((6, 4), torch.bfloat16)
    got = tckpt.local_shard(leaf.clone(), torch.zeros(6, 4,
                                                      dtype=torch.float32))
    assert torch.equal(got, leaf.float())
    with pytest.raises(ValueError, match="cannot take the place"):
        tckpt.local_shard(leaf, torch.zeros(4, 6))


# --------------------------------------------------------------------------
# real gloo runs of the launcher on a (2, 2) mesh
# --------------------------------------------------------------------------


def _reference_run(directory):
    """The reference's 4 steps on gemma-2b's smoke config in f32, saving
    at step 2 into ``directory``: each step's loss, the f64 norm of the
    gradient of steps 2 and 3, and its state at step 4, flattened."""
    jcfg = W.config(jconfigs)
    opt = joptim.make_optimizer("adamw",
                                joptim.cosine_schedule(W.LR, W.STEPS, 5))
    params = jmodel.init(jax.random.PRNGKey(0), jcfg)
    opt_state = opt.init(params)
    step_fn = jax.jit(jmake_train_step(jcfg, opt))
    task = JTextTask(vocab=min(jcfg.vocab, 512), seq_len=W.SEQ)
    rng = np.random.default_rng(0)
    steps = []
    for i in range(W.STEPS):
        toks, labels = j_lm_batches(task.train, W.BATCH, rng)
        batch = {"tokens": jnp.asarray(toks % jcfg.vocab),
                 "labels": jnp.asarray(labels % jcfg.vocab)}
        norm = None
        if i >= W.STOP:
            grads = jax.grad(lambda p: jmodel.loss_fn(p, jcfg, batch)[0])(
                params)
            norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                               for g in jax.tree_util.tree_leaves(grads)))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        steps.append((float(metrics["loss"]), norm))
        if i + 1 == W.STOP:
            jckpt.save_checkpoint(directory, W.STOP,
                                  {"params": params, "opt": opt_state})
    return steps, jckpt._flatten(jax.device_get({"params": params,
                                                 "opt": opt_state}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_ckpt")
    ref_steps, ref_state = _reference_run(base / "ref")

    def spawn(jobs):
        mp.start_processes(W.run, args=(4, str(base / f"init_{jobs[0]}"),
                                        str(base), jobs),
                           nprocs=4, join=True, start_method="spawn")
        return [torch.load(base / f"{jobs[0]}.rank{r}.pt") for r in range(4)]

    ranks = spawn(("full", "fresh", "ref"))
    step = f"step_{W.STOP:08d}"
    shutil.copytree(base / "full" / step, base / "cut" / step)
    for r, rec in enumerate(spawn(("cut",))):
        ranks[r].update(rec)
    return {"base": base, "ranks": ranks, "ref_steps": ref_steps,
            "ref_state": ref_state}


def _payload(path):
    return (path / "state.msgpack").read_bytes()


def test_resumed_mesh_run_is_the_uninterrupted_one(runs):
    last = f"step_{W.STEPS:08d}"
    assert (_payload(runs["base"] / "cut" / last)
            == _payload(runs["base"] / "full" / last))
    for rec in runs["ranks"]:
        assert len(rec["full"]["steps"]) == W.STEPS
        assert rec["cut"]["steps"] == rec["full"]["steps"][W.STOP:]


def test_fresh_mesh_checkpoint_is_the_one_device_file(runs, tmp_path):
    cfg = W.config(tconfigs)
    params = tmodel.init(0, cfg, "cpu")
    opt = make_optimizer("adamw", cosine_schedule(W.LR, W.STEPS, 5))
    one = tckpt.save_checkpoint(tmp_path, 0, {"params": params,
                                              "opt": opt.init(params)})
    assert _payload(runs["base"] / "fresh" / "step_00000000") == _payload(one)


def test_every_rank_returns_once_the_step_directory_exists(runs):
    for rec in runs["ranks"]:
        saved = [s for job in rec.values() for s in job["saved"]]
        assert len(saved) == 5 and all(ok for _, ok in saved)


def test_reference_checkpoint_restores_into_every_ranks_shards(runs):
    n = len(runs["ref_state"])
    for rec in runs["ranks"]:
        for job in ("ref", "cut"):
            assert len(rec[job]["restored"]) == n
            assert all(rec[job]["restored"])


def test_reference_checkpoint_continues_on_the_mesh(runs):
    want = runs["ref_steps"][W.STOP:]
    for rec in runs["ranks"]:
        got = rec["ref"]["steps"]
        assert len(got) == len(want)
        for (loss, norm), (jloss, jnorm) in zip(got, want):
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            np.testing.assert_allclose(norm, jnorm, rtol=1e-5)


def test_mesh_checkpoint_loads_in_the_reference(runs):
    back = jckpt.load_checkpoint(runs["base"] / "ref" / f"step_{W.STEPS:08d}")
    got = jckpt._flatten(back)
    want = runs["ref_state"]
    assert list(got) == list(want)
    for k, v in want.items():
        assert (got[k].dtype, got[k].shape) == (v.dtype, v.shape), k
    assert int(back["opt"]["step"]) == W.STEPS


# --------------------------------------------------------------------------
# the pod mesh, as rank 0 of a fake world of 256
# --------------------------------------------------------------------------

POD = ["--smoke", "--steps", "1", "--batch", "16", "--seq", "16",
       "--device", "cpu", "--ckpt-every", "1"]


def _header(path):
    return {k: (str(np.asarray(v).dtype) if not torch.is_tensor(v)
                else str(v.dtype), tuple(v.shape))
            for k, v in tckpt._flatten(tckpt.load_checkpoint(path)).items()}


def test_pod_mesh_launcher_checkpoints_and_resumes(tmp_path, capsys,
                                                   monkeypatch):
    host, pod = tmp_path / "host", tmp_path / "pod"
    ttrain.main([*POD, "--ckpt-dir", str(host)])
    checked = {"saved": 0, "restored": 0}
    real_save, real_into = ttrain.save_checkpoint, ttrain._into_layout

    def save(directory, step, state):
        path = real_save(directory, step, state)
        saved = tckpt.load_checkpoint(path)

        def held(leaf, file_leaf):
            shape, offset = compute_local_shape_and_global_offset(
                leaf.shape, leaf.device_mesh, leaf.placements)
            assert W.same_bits(_region(file_leaf, shape, offset),
                               leaf.to_local())
            checked["saved"] += 1
        tree_map(held, state, saved)
        return path

    def into(tree, like):
        got = real_into(tree, like)

        def held(ref, a, g):
            want = distribute_tensor(torch.as_tensor(a).clone(),
                                     ref.device_mesh, ref.placements,
                                     src_data_rank=None).to_local()
            assert W.same_bits(g.to_local(), want)
            assert g.placements == ref.placements
            checked["restored"] += 1
        tree_map(held, like, tree, got)
        return got

    monkeypatch.setattr(ttrain, "save_checkpoint", save)
    monkeypatch.setattr(ttrain, "_into_layout", into)
    for steps in ("1", "2"):
        capsys.readouterr()
        with fake_world(256):
            ttrain.main([*POD, "--mesh", "pod", "--steps", steps,
                         "--ckpt-dir", str(pod)])
        out = capsys.readouterr().out
        assert ("resumed from step 1" in out) == (steps == "2")
        assert out.rstrip().endswith("done.")
    n = len(_header(host / "step_00000001"))
    assert checked == {"saved": 2 * n, "restored": n}
    for step in ("step_00000001", "step_00000002"):
        assert _header(pod / step) == _header(host / "step_00000001")
