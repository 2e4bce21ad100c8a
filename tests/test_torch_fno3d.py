"""The port's FNO3d (models/fno3d.py, train/train_fno3d.py) vs the JAX package's.

The small FNO3d (16², 6 steps, width 8, modes 4/4/2, 2 layers, b=2) runs on
the same numpy input with the same flax parameters, carried across by
``tpu_cfd_torch.convert`` (perturbed from flax's init so that no bias sits at
zero): forward to 1e-5 of the largest reference entry, per-leaf gradients to
1e-4 of the leaf's largest entry; bf16 activations to the rel-L2 0.05 of
``tests/test_models.py``; remat on equals remat off exactly. The training CLI
runs end to end on the CPU at 16² from an ``.npz`` and from a MATLAB file, and
one epoch of it from the example's own initial parameters gives the test loss
of ``examples/ex2_fno3d_train.py`` on the same file to 1e-3.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from tpu_cfd.models import fno3d as jfno
from tpu_cfd_torch import convert
from tpu_cfd_torch import models as tm
from tpu_cfd_torch.data.datasets import load_trajectory_dict
from tpu_cfd_torch.train import train_fno3d

torch.set_num_threads(2)

KW = dict(modes1=4, modes2=4, modes3=2, width=8, num_spectral_layers=2,
          channel_expansion=16)
SHAPE = (2, 16, 16, 6, 13)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _input(seed=1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)

    def f(p):
        p = np.asarray(p)
        scale = 0.1 * max(float(np.abs(p).max()), 0.1)
        return (p + scale * rng.standard_normal(p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(f, jax.device_get(params))


def _pair(**extra):
    jmod, x = jfno.FNO3d(**KW, **extra), _input()
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    tmod = tm.FNO3d(**KW, **extra)
    tmod.load_state_dict(convert.fno3d_state_dict_from_flax(params))
    return jmod, tmod, params, x


@pytest.mark.parametrize("extra", [{}, {"padding": 2}, {"last_activation": True},
                                   {"remat": True}], ids=str)
def test_fno3d_forward_and_grads(extra):
    jmod, tmod, params, x = _pair(**extra)
    r = np.random.default_rng(5).standard_normal(SHAPE[:-1]).astype(np.float32)

    def loss(p):
        out, aux = jmod.apply(p, x)
        assert aux is None
        return (out * r).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out_t, aux = tmod(torch.from_numpy(x))
    assert aux is None and out_t.shape == out_j.shape
    (out_t * torch.from_numpy(r)).sum().backward()
    assert _rel_err(out_t.detach(), out_j) < 1e-5
    g_j = convert.state_dict_from_flax("FNO3d", jax.device_get(g_j))
    for name, p in tmod.named_parameters():
        assert _rel_err(p.grad, g_j[name]) < 1e-4, name


def test_fno3d_remat_identical():
    _, m0, _, x = _pair()
    m1 = tm.FNO3d(**KW, remat=True)
    m1.load_state_dict(m0.state_dict())
    assert m0.state_dict().keys() == m1.state_dict().keys()
    outs = []
    for m in (m0, m1):
        out, _ = m(torch.from_numpy(x))
        out.square().mean().backward()
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    for (name, p0), (_, p1) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(p0.grad, p1.grad), name
    with torch.no_grad():  # no checkpoint without a graph
        assert torch.equal(m1(torch.from_numpy(x))[0], outs[0])


def test_fno3d_bf16_compute_dtype():
    jmod, tmod, params, x = _pair(compute_dtype="bfloat16")
    t32 = tm.FNO3d(**KW)
    t32.load_state_dict(tmod.state_dict())
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    o16, _ = tmod(torch.from_numpy(x))
    o32, _ = t32(torch.from_numpy(x))
    assert o16.dtype == torch.float32
    assert 0 < _rel_l2(o16.detach(), o32.detach()) < 0.05
    assert _rel_l2(o16.detach(), jmod.apply(params, x)[0]) < 0.05
    o16.square().mean().backward()
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tmod.parameters())


def test_add_grid_3d_and_input():
    x = _input()[..., :10]
    want = np.asarray(jfno.add_grid_3d(jnp.asarray(x)))
    got = tm.add_grid_3d(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 16, 6, 13) and _rel_err(got, want) < 1e-6
    a = _input(2)[:, :, :, 0, :10]                       # (b, n, n, T_in)
    full = tm.make_fno3d_input(torch.from_numpy(a), 7).numpy()
    assert full.shape == (2, 16, 16, 7, 13)
    assert np.array_equal(full[:, :, :, 3, :10], a)
    assert full[0, 0, 0, :, 12] == pytest.approx(np.linspace(0, 1, 8)[1:])


def test_fno3d_parameter_count_at_the_example_defaults():
    """modes 32/5, width 10, 10 input steps: the flax model's count, without
    materialising its parameters."""
    jmod = jfno.FNO3d(modes1=32, modes2=32, modes3=5, width=10, input_channel=10)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 10, 13), jnp.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    got = tm.num_parameters(tm.FNO3d(32, 32, 5, width=10, input_channel=10))
    assert got == want == 16_386_997


def test_convert_round_trip_and_rejects():
    _, tmod, params, _ = _pair()
    back = convert.fno3d_flax_from_state_dict(convert.fno3d_state_dict_from_flax(params))
    flat = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    assert all(np.array_equal(np.asarray(a), flat_back[k]) for k, a in flat.items())
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    with pytest.raises(KeyError, match="unknown"):
        convert.fno3d_state_dict_from_flax({**tree, "Dense_9": {"kernel": np.zeros(1)}})
    with pytest.raises(KeyError, match="MLP3d_2"):
        convert.fno3d_state_dict_from_flax(
            {k: v for k, v in tree.items() if k != "MLP3d_2"})
    with pytest.raises(KeyError, match="unknown"):
        convert.fno3d_flax_from_state_dict({**tmod.state_dict(), "x.weight": torch.zeros(1)})


CLI = ["--no-cuda", "--num-samples", "8", "--num-test-samples", "2", "--epochs", "2",
       "--batch-size", "2", "--modes", "4", "--modes-t", "2", "--width", "4",
       "--time-steps", "5", "--res", "16"]


def _check_run(out):
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite([h["train"] for h in hist] + [h["test"] for h in hist]))
    assert out["test"] == hist[-1]["test"]
    assert out["n_params"] == tm.num_parameters(out["model"])
    assert isinstance(out["model"], tm.FNO3d)


def test_cli_trains_from_an_npz(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "traj.npz"
    np.savez(path, vorticity=rng.standard_normal((10, 14, 16, 16)).astype(np.float32))
    _check_run(train_fno3d.main([*CLI, "--data-file", str(path), "--t-start", "2"]))
    with pytest.raises(ValueError, match="fewer than --t-start 10"):
        train_fno3d.main([*CLI, "--data-file", str(path), "--t-start", "10"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_fno3d.main([*CLI[1:], "--data-file", str(path), "--t-start", "2"])


def test_cli_matches_the_jax_example_over_one_epoch(tmp_path, monkeypatch):
    """Four Adam steps at a constant rate and the eval, on the same file and
    from the same parameters: the test sets' normalisation (own statistics,
    denormalised with the train set's) shows in the test loss: transforming
    the test set with the train statistics instead moves it by 7e-3 of the
    loss. Measured difference 1.3e-7 of the loss; the bound leaves room for
    four fp32 Adam steps through two FFT libraries."""
    spec = importlib.util.spec_from_file_location(
        "ex2_fno3d_train",
        pathlib.Path(__file__).parents[1] / "examples" / "ex2_fno3d_train.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rng = np.random.default_rng(3)
    path = tmp_path / "traj.npz"
    # per-sample offsets, so that train and test statistics differ visibly
    data = rng.standard_normal((10, 14, 16, 16)) + rng.standard_normal((10, 1, 1, 1))
    np.savez(path, vorticity=data.astype(np.float32))
    argv = [*CLI[1:], "--data-file", str(path), "--t-start", "2", "--epochs", "1"]
    want = example.main(argv)

    jmod = jfno.FNO3d(modes1=4, modes2=4, modes3=2, width=4, input_channel=5)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(42), jnp.zeros((2, 16, 16, 5, 8)))
    state = convert.fno3d_state_dict_from_flax(jax.device_get(params))

    def load(model, generator):
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(train_fno3d, "init_like_flax", load)
    got = train_fno3d.main(["--no-cuda", *argv])
    assert got["test"] == pytest.approx(want, rel=1e-3)


def test_cli_trains_from_a_matlab_file(tmp_path):
    u = np.random.default_rng(1).standard_normal((10, 16, 16, 12)).astype(np.float32)
    path = tmp_path / "ns.mat"
    sio.savemat(path, {"u": u})
    assert np.array_equal(load_trajectory_dict(path)["u"], u)
    _check_run(train_fno3d.main([*CLI, "--mat-file", str(path)]))


def test_matlab_v73_needs_h5py(tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    u = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path = tmp_path / "v73.mat"
    with h5py.File(path, "w") as f:
        f["u"] = u.T  # MATLAB stores column-major
    assert np.array_equal(load_trajectory_dict(path)["u"], u)
    monkeypatch.setitem(sys.modules, "h5py", None)  # as where h5py is missing
    with pytest.raises(ImportError, match="needs the h5py package"):
        load_trajectory_dict(path)
