"""The port's data parallelism (``tpu_cfd_torch.parallel``) on the CPU.

World size 2 on gloo: each test spawns two processes that meet through a
file store in the test's own directory (a fixed TCP port would collide
between test workers). What the JAX package's ``tests/test_parallel.py``
holds for its 8-device mesh, held here for two ranks: the mesh's shape and
the batch's layout over it; ``generate --data-parallel`` stores the
single-process dataset within the JAX test's tolerances (integer fields
exactly, ``vort_t`` and ``residual`` to 1e-4 of max|vort_t|, the other
fields to 1e-5 of their largest entry), on a ragged batch too; and
``train --data-parallel`` ends within rtol 2e-4, atol 2e-6 of the
single-process parameters.
"""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_cfd_torch import parallel
from tpu_cfd_torch.data import generate
from tpu_cfd_torch.train import pipeline, train

torch.set_num_threads(2)

WORLD = 2
GEN_ARGS = ["--no-cuda", "--grid-size", "32", "--num-samples", "8", "--time", "0.03",
            "--time-warmup", "0.01", "--dt", "1e-3", "--num-steps", "2", "--extra-vars"]


def _in_world(rank, init, target, *args):
    """One rank: joins the gloo world through ``init``, runs
    ``target(rank, *args)``, leaves."""
    torch.set_num_threads(2)
    # a collective left waiting fails within a minute instead of stalling the suite
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        target(rank, *args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, target, *args):
    mp.spawn(_in_world, args=(f"file://{tmp_path}/store", target, *args),
             nprocs=WORLD, join=True)


def _mesh_checks(rank, tmp):
    mesh = parallel.make_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": WORLD, "model": 1}
    with pytest.raises(ValueError, match="n_devices"):
        parallel.make_mesh(n_devices=WORLD + 1)
    # the leading axis in rank order: rows 0-3 on rank 0, 4-7 on rank 1
    x = torch.arange(8.0 * 4).reshape(8, 4)
    xs = parallel.shard_batch(x, mesh)
    assert torch.equal(xs, x[4 * rank: 4 * rank + 4])
    got = parallel.gather_batch(xs.numpy(), mesh)
    if rank == 0:
        np.testing.assert_array_equal(got, x.numpy())
    else:
        assert got is None
    # ragged, and a rank that holds none: np.array_split's layout
    for rows in (7, 1):
        ids = np.arange(rows)
        mine = parallel.shard_batch({"ids": ids}, mesh)["ids"]
        np.testing.assert_array_equal(mine, np.array_split(ids, WORLD)[rank])
        got = parallel.gather_batch({"ids": mine} if len(mine) else None, mesh)
        if rank == 0:
            np.testing.assert_array_equal(got["ids"], ids)
    # broadcast from rank 0, in place, a tensor and a module
    t = torch.full((3,), float(rank))
    assert torch.equal(parallel.replicate(t, mesh), torch.zeros(3))
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
    parallel.replicate(lin, mesh)
    assert torch.equal(lin.weight, torch.zeros(2, 2))
    assert parallel.all_ranks(True, mesh) and not parallel.all_ranks(rank == 0, mesh)
    # the train CLI refuses a batch the world does not divide, on every rank
    with pytest.raises(ValueError, match="divisible by the world size 2"):
        train.main(["--no-cuda", "--data-parallel", "--batch-size", "3"])


def test_mesh_shape_and_batch_layout(tmp_path):
    _spawn(tmp_path, _mesh_checks, str(tmp_path))


def _generate(rank, argv):
    generate.main_mcwilliams(argv)


def _assert_same_dataset(p1, p2):
    """The JAX test's tolerances (tests/test_parallel.py:215-239)."""
    with np.load(p1) as a, np.load(p2) as b:
        assert set(a.files) == set(b.files)
        scale_vt = np.abs(a["vort_t"]).max()
        for k in a.files:
            x, y = a[k], b[k]
            if x.dtype.kind in "iu":
                np.testing.assert_array_equal(x, y)
                continue
            atol = 1e-4 * scale_vt if k in ("vort_t", "residual") else 1e-5 * np.abs(x).max()
            np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                       err_msg=f"field {k} differs under --data-parallel")


@pytest.mark.parametrize("batch", [8, 7])
def test_generate_data_parallel_equals_single_process(tmp_path, batch):
    """8 samples at 32², one batch of 8 (4 a rank) or batches of 7 and 1
    (rank 1 holds none of the second)."""
    common = GEN_ARGS + ["--batch-size", str(batch)]
    p1 = generate.main_mcwilliams(common + ["--filepath", str(tmp_path / "single")])
    _spawn(tmp_path, _generate,
           common + ["--filepath", str(tmp_path / "dp"), "--data-parallel"])
    p2 = os.path.join(tmp_path / "dp", os.path.basename(p1))
    _assert_same_dataset(p1, p2)
    with open(p1 + ".meta.json") as f1, open(p2 + ".meta.json") as f2:
        assert f1.read() == f2.read()


def _trajectories(path):
    """The JAX test's 16 trajectories of 12 steps at 16² (tests/test_parallel.py:161-176)."""
    n, T = 16, 12
    rng = np.random.default_rng(0)
    xg, yg = np.meshgrid(np.linspace(0, 2 * np.pi, n, endpoint=False),
                         np.linspace(0, 2 * np.pi, n, endpoint=False), indexing="ij")
    trajs = [[np.sin(xg + 0.3 * t + rng.uniform(0, 2 * np.pi)) * np.cos(yg - 0.2 * t)
              for t in range(T)] for _ in range(16)]
    np.savez(path, vorticity=np.asarray(trajs, dtype=np.float32))


def _train_argv(tmp, extra):
    return ["--no-cuda", "--train-file", f"{tmp}/traj.npz", "--train-only", "--epochs", "2",
            "--batch-size", "8", "--num-samples", "16", "--num-val-samples", "8",
            "--res", "16", "--modes", "4", "--modes-t", "2", "--width", "8",
            "--latent-steps", "4", "--num-layers", "2", "--time-steps", "4",
            "--out-time-steps", "4", "--lr", "1e-3", *extra]


def _train_paths(tmp, tag):
    for mod in (pipeline, train):
        mod.MODEL_PATH = os.path.join(tmp, tag, "models")
        mod.LOG_PATH = os.path.join(tmp, tag, "logs")


def _train(rank, tmp, extra):
    _train_paths(tmp, f"rank{rank}")
    out = train.main(_train_argv(tmp, ["--data-parallel", *extra]))
    if rank == 0:
        torch.save({"state": out["model"].state_dict(), "history": out["history"]},
                   os.path.join(tmp, "dp.pt"))
    # rank 0 alone writes checkpoints and logs
    assert os.path.exists(os.path.join(tmp, f"rank{rank}", "models")) == (rank == 0)


@pytest.mark.parametrize("extra", [[], ["--remat", "--compute-dtype", "bfloat16"]],
                         ids=["fp32", "remat_bf16"])
def test_train_data_parallel_equals_single_process(tmp_path, monkeypatch, extra):
    """2 epochs of 2 steps at batch 8, 4 samples a rank. In fp32 the
    parameters match to the JAX test's rtol 2e-4, atol 2e-6; with remat and
    bf16 activations, where Adam magnifies the bf16 noise of near-zero
    gradients, the logged losses match to 1e-5."""
    _trajectories(tmp_path / "traj.npz")
    for mod in (pipeline, train):
        monkeypatch.setattr(mod, "MODEL_PATH", str(tmp_path / "single" / "models"))
        monkeypatch.setattr(mod, "LOG_PATH", str(tmp_path / "single" / "logs"))
    single = train.main(_train_argv(tmp_path, extra))
    _spawn(tmp_path, _train, str(tmp_path), extra)
    dp = torch.load(tmp_path / "dp.pt", weights_only=True)
    for a, b in zip(single["history"], dp["history"]):
        for key in ("train", "val"):
            assert b[key] == pytest.approx(a[key], rel=1e-5), (key, a, b)
    if not extra:
        for k, v in single["model"].state_dict().items():
            np.testing.assert_allclose(dp["state"][k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=k)


def test_launch_joins_a_torchrun_world(tmp_path, monkeypatch):
    """Under ``torch.distributed.run``'s variables the CLI joins the world it
    was given (here one rank on gloo) and leaves it when done."""
    from tpu_cfd_torch.parallel.launch import _free_port

    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(var, value)
    seen = []

    def main(argv):
        seen.append((argv, dist.get_world_size(), dist.get_backend()))
        return "done"

    assert parallel.launch(main, ["--x"], cuda=False) == "done"
    assert seen == [(["--x"], 1, "gloo")] and not dist.is_initialized()
