"""The port's training pieces (train/, data/datasets.py) vs the JAX package's.

SobolevLoss, the one-cycle schedule, the dataset's windows and one Adam step
of the small SFNO from converted flax parameters, each on the same numpy
inputs as the JAX counterpart; and a ``--no-cuda`` run of the training CLI
on a dataset that the port's generator writes. Tolerances: losses to 1e-5
relative; gradients and Adam's first moments to 1e-4 of each leaf's largest
entry, second moments (squares of the gradient, so twice its relative
error) to 2e-4. A gradient entry sums thousands of fp32 terms as large as
the model's largest gradient, so its noise is about 1e-6 of that: a leaf
whose gradient lies below 1e-2 of the largest (a few output-bias leaves sit
near 3e-5 of it) is held to that floor instead of its own largest entry.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from tpu_cfd import models as jm
from tpu_cfd.data.datasets import SpatioTemporalDataset as JaxDataset
from tpu_cfd.train import losses as jlosses, pipeline as jpipeline
from tpu_cfd_torch import convert
from tpu_cfd_torch import models as tm
from tpu_cfd_torch.data import generate
from tpu_cfd_torch.data.datasets import SpatioTemporalDataset, load_trajectory_dict
from tpu_cfd_torch.train import losses as tlosses, pipeline as tpipeline, train

torch.set_num_threads(2)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("norm_order", [0.0, -1.0, 1.0])
def test_sobolev_loss_matches_jax(norm_order, relative):
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal((3, 16, 16, 5)).astype(np.float32) for _ in range(2))
    kw = dict(n_grid=16, norm_order=norm_order, relative=relative, freq_cutoff=6)
    want = float(jlosses.SobolevLoss(**kw)(x, y))
    got = float(tlosses.SobolevLoss(**kw)(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_lp_and_l2_losses_match_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((3, 8, 8)).astype(np.float32) for _ in range(2))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for relative in (True, False):
        assert abs(float(tlosses.LpLoss(relative=relative)(tx, ty))
                   - float(jlosses.LpLoss(relative=relative)(x, y))) < 1e-5
    g = rng.standard_normal((3, 16, 8)).astype(np.float32)
    want = float(jlosses.L2Loss2d()(x, y, targets_grad=g))
    got = float(tlosses.L2Loss2d()(tx, ty, targets_grad=torch.from_numpy(g)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("steps_per_epoch,epochs", [(7, 3), (2, 2), (1, 4)])
def test_onecycle_matches_optax(steps_per_epoch, epochs):
    """Every step's lr, including the constant schedule below 5 steps."""
    want = jpipeline.onecycle_lr(0.01, steps_per_epoch, epochs)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    sched = tpipeline.onecycle_lr(opt, 0.01, steps_per_epoch, epochs)
    for step in range(steps_per_epoch * epochs + 2):
        got = opt.param_groups[0]["lr"]
        assert got == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step
        opt.step()
        sched.step()


def test_dataset_windows_match_jax():
    rng = np.random.default_rng(2)
    data = {"vorticity": rng.standard_normal((9, 30, 8, 8)).astype(np.float32)}
    jds = JaxDataset(dict(data), n_samples=7, fields=["vorticity"], steps=4, out_steps=3)
    tds = SpatioTemporalDataset(dict(data), n_samples=7, fields=["vorticity"],
                                steps=4, out_steps=3)
    for shuffle in (True, False):
        ji, js = jds.epoch_indices(3, np.random.default_rng(5), shuffle)
        ti, ts = tds.epoch_indices(3, np.random.default_rng(5), shuffle)
        assert np.array_equal(ji, ti) and np.array_equal(js, ts)
    (jin, jout), (tin, tout) = jds.sample_at(ji[0], js[0]), tds.sample_at(ti[0], ts[0])
    assert np.array_equal(jin["vorticity"], tin["vorticity"])
    assert np.array_equal(jout["vorticity"], tout["vorticity"])
    # the device-resident gather picks the same windows
    gather = tpipeline._window_gather(torch.from_numpy(tds.data["vorticity"]), 4, 3)
    a, u = gather(torch.from_numpy(ti[0]).long(), torch.from_numpy(ts[0]).long())
    assert np.array_equal(a.numpy(), tin["vorticity"])
    assert np.array_equal(u.numpy(), tout["vorticity"])
    with pytest.raises(FileNotFoundError):  # .mat is a format the port reads
        load_trajectory_dict("x.mat")


def test_one_adam_step_matches_optax():
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=4, num_spectral_layers=3,
              activation="GELU", beta=0.0)
    rng = np.random.default_rng(3)
    inp, target = (rng.standard_normal((2, 16, 16, 10)).astype(np.float32)
                   for _ in range(2))
    jmod = jm.SFNO(**kw)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0), inp))
    jloss = jlosses.SobolevLoss(n_grid=16, norm_order=0.0, relative=True)
    opt = optax.adam(1e-3)

    @jax.jit
    def jstep(p):
        loss, g = jax.value_and_grad(lambda q: jloss(jmod.apply(q, inp), target))(p)
        updates, state = opt.update(g, opt.init(p), p)
        return loss, g, optax.apply_updates(p, updates), state[0]

    loss_j, g_j, new_j, adam_j = jax.device_get(jstep(params))

    model = tm.SFNO(**kw)
    model.load_state_dict(convert.sfno_state_dict_from_flax(params))
    topt = tpipeline.get_optimizer("Adam", model.parameters(), 1e-3)
    step = tpipeline.make_train_step(
        model, tlosses.SobolevLoss(n_grid=16, norm_order=0.0, relative=True), topt)
    loss_t = float(step(torch.from_numpy(inp), torch.from_numpy(target)))
    assert abs(loss_t - float(loss_j)) <= 1e-5 * abs(float(loss_j))

    as_np = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                          convert.sfno_state_dict_from_flax(tree).items()}
    g_j, new_j = as_np(g_j), as_np(new_j)
    mu_j, nu_j = as_np(adam_j.mu), as_np(adam_j.nu)
    floor = 1e-2 * max(np.abs(g).max() for g in g_j.values())

    def err(got, want, fl):
        return float(np.abs(got - want).max() / max(np.abs(want).max(), fl))

    for name, p in model.named_parameters():
        st = topt.state[p]
        g = p.grad.numpy()
        assert err(g, g_j[name], floor) < 1e-4, name
        assert err(st["exp_avg"].numpy(), mu_j[name], 0.1 * floor) < 1e-4, name
        assert err(st["exp_avg_sq"].numpy(), nu_j[name], 1e-3 * floor ** 2) < 2e-4, name
        # the first update is -lr * g/(|g| + 1e-8), about -lr * sign(g):
        # compare it only where |g| is above the fp32 noise of its leaf and
        # 100x Adam's eps, where it stops depending on eps
        leaf = max(np.abs(g_j[name]).max(), floor)
        big = np.abs(g_j[name]) > max(1e-3 * leaf, 1e-6)
        np.testing.assert_allclose(p.detach().numpy()[big], new_j[name][big],
                                   rtol=0, atol=1e-6, err_msg=name)


def test_lion_matches_optax():
    """Three steps with optax.lion's defaults, on a one-cycle schedule."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(3)]
    lrs = [1e-2, 3e-2, 2e-2]
    tx = optax.lion(lambda count: jax.numpy.asarray(lrs)[count])
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tpipeline.get_optimizer("Lion", [tp], lrs[0])
    assert isinstance(opt, tpipeline.Lion)
    assert opt.defaults == dict(lr=lrs[0], b1=0.9, b2=0.99, weight_decay=1e-3)
    for lr, g in zip(lrs, grads):
        updates, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.param_groups[0]["lr"] = lr
        tp.grad = torch.from_numpy(g)
        opt.step()
        assert _rel_err(tp.detach().numpy(), jp) < 1e-6
    assert _rel_err(opt.state[tp]["exp_avg"].numpy(), state[0].mu) < 1e-6


def test_optimizers_and_unported_flags():
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(tpipeline.get_optimizer("AdamW", p), torch.optim.AdamW)
    assert isinstance(tpipeline.get_optimizer("sgd", p), torch.optim.SGD)
    assert isinstance(tpipeline.get_optimizer("Lion", p), tpipeline.Lion)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tpipeline.get_optimizer("lamb", p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main([])


def test_cli_runs_data_parallel_and_demo_plots(tmp_path, monkeypatch):
    """``--data-parallel --no-cuda`` trains in a world of one, as without the
    flag; ``--demo-plots 2`` draws two test samples' predicted and true
    trajectories after the eval phase."""
    import matplotlib

    matplotlib.use("Agg")
    rng = np.random.default_rng(7)
    path = tmp_path / "traj.npz"
    np.savez(path, vorticity=rng.standard_normal((6, 25, 16, 16)).astype(np.float32))
    for var, sub in (("MODEL_PATH", "m"), ("LOG_PATH", "l"), ("FIG_PATH", "f")):
        monkeypatch.setattr(tpipeline, var, str(tmp_path / sub))
    monkeypatch.setattr(train, "MODEL_PATH", str(tmp_path / "m"))
    monkeypatch.setattr(train, "LOG_PATH", str(tmp_path / "l"))
    common = ["--no-cuda", "--example", "McWilliams2d", "--train-file", str(path),
              "--res", "16", "--modes", "4", "--modes-t", "3", "--width", "4",
              "--num-layers", "3", "--batch-size", "2", "--epochs", "2",
              "--num-samples", "4", "--num-val-samples", "2", "--train-only"]
    base = train.main(common)
    dp = train.main([*common, "--data-parallel"])
    assert not torch.distributed.is_initialized()
    assert dp["history"] == [dict(h, seconds=d["seconds"])
                             for h, d in zip(base["history"], dp["history"])]
    for k, v in base["model"].state_dict().items():
        assert torch.equal(dp["model"].state_dict()[k], v), k
    out = train.main([*common[:-1], "--eval-only", "--test-file", str(path),
                      "--test-res", "16", "--num-test-samples", "2",
                      "--test-t-start", "2", "--demo-plots", "2"])
    assert np.isfinite(out["test"])
    want = [str(tmp_path / "f" / f"McWilliams2d_16x16_sample{i}_{name}.png")
            for i in range(2) for name in ("pred", "true")]
    assert out["demo_plots"] == want and all(os.path.exists(f) for f in want)


def test_cli_takes_bf16_remat_and_lion(tmp_path, monkeypatch):
    """``--compute-dtype bfloat16 --remat --optimizer lion`` on the CPU, from
    an array that stands in for a generated dataset."""
    rng = np.random.default_rng(6)
    path = tmp_path / "traj.npz"
    np.savez(path, vorticity=rng.standard_normal((6, 25, 16, 16)).astype(np.float32))
    for var, sub in (("MODEL_PATH", "m"), ("LOG_PATH", "l"), ("FIG_PATH", "f")):
        monkeypatch.setattr(tpipeline, var, str(tmp_path / sub))
    monkeypatch.setattr(train, "MODEL_PATH", str(tmp_path / "m"))
    monkeypatch.setattr(train, "LOG_PATH", str(tmp_path / "l"))
    common = ["--no-cuda", "--example", "McWilliams2d", "--train-file", str(path),
              "--res", "16", "--modes", "4", "--modes-t", "3", "--width", "4",
              "--num-layers", "3", "--batch-size", "2", "--epochs", "2",
              "--num-samples", "4", "--num-val-samples", "2", "--train-only",
              "--lr", "1e-3"]
    base = train.main(common)
    for flags in (["--compute-dtype", "bfloat16"], ["--remat"],
                  ["--optimizer", "lion"],
                  ["--compute-dtype", "bfloat16", "--remat", "--optimizer", "lion"]):
        out = train.main([*common, *flags])
        hist = out["history"]
        assert len(hist) == 2, flags
        assert all(np.isfinite([h["train"] for h in hist] + [h["val"] for h in hist]))
        assert out["n_params"] == base["n_params"]
        assert all(p.dtype == torch.float32 for p in out["model"].parameters())
        # the same draws and the same initial parameters: the first epoch's
        # loss moves by bf16 rounding or by the optimizer only
        assert hist[0]["train"] == pytest.approx(base["history"][0]["train"], rel=0.05)
        if flags == ["--remat"]:
            assert hist[1]["train"] == pytest.approx(base["history"][1]["train"], rel=1e-5)
            assert out["model"].remat and not base["model"].remat


def test_cli_trains_on_a_generated_dataset(tmp_path, monkeypatch):
    """``--no-cuda`` end to end: the port's McWilliams generator at 32²→16²
    writes the data, the CLI trains 2 epochs on it and saves a checkpoint."""
    path = generate.main_mcwilliams([
        "--no-cuda", "--grid-size", "32", "--subsample", "2", "--num-samples", "6",
        "--batch-size", "6", "--time", "0.05", "--time-warmup", "0.01",
        "--dt", "1e-3", "--num-steps", "25", "--filepath", str(tmp_path)])
    for var, sub in (("MODEL_PATH", "m"), ("LOG_PATH", "l"), ("FIG_PATH", "f")):
        monkeypatch.setattr(tpipeline, var, str(tmp_path / sub))
    monkeypatch.setattr(train, "MODEL_PATH", str(tmp_path / "m"))
    monkeypatch.setattr(train, "LOG_PATH", str(tmp_path / "l"))
    out = train.main([
        "--no-cuda", "--example", "McWilliams2d", "--train-file", path,
        "--res", "16", "--modes", "4", "--modes-t", "3", "--width", "4",
        "--num-layers", "3", "--batch-size", "2", "--epochs", "2",
        "--num-samples", "4", "--num-val-samples", "2", "--train-only"])
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite([h["train"] for h in hist] + [h["val"] for h in hist]))
    assert out["n_params"] == tm.num_parameters(out["model"])
    ckpt = tmp_path / "m" / "sfno_McWilliams2d_16x16_m4_w4.pt"
    assert ckpt.exists()
    with open(path + ".meta.json") as f:
        assert json.load(f)["fft_impl"]
    # the eval phase from that checkpoint, in float64 (``_dft_apply`` and the
    # plain FFN, as no fp64 kernel exists)
    evaluated = train.main([
        "--no-cuda", "--example", "McWilliams2d", "--train-file", path,
        "--test-file", path, "--res", "16", "--test-res", "16", "--modes", "4",
        "--modes-t", "3", "--width", "4", "--num-layers", "3", "--eval-only",
        "--double", "--num-test-samples", "2", "--test-t-start", "5"])
    assert np.isfinite(evaluated["test"]) and evaluated["history"] == []
    assert next(evaluated["model"].parameters()).dtype == torch.float64
    # the JAX dataset reads the port's file and draws the same windows
    jds = JaxDataset(path, n_samples=4, fields=["vorticity"], steps=10, out_steps=10)
    tds = SpatioTemporalDataset(path, n_samples=4, fields=["vorticity"], steps=10,
                                out_steps=10)
    assert np.array_equal(jds.data["vorticity"], tds.data["vorticity"])


# keys of the JAX run's log that the port's training CLI does not share with
# it in meaning, and the file that the recipe run passes itself
_LOG_KEYS_NOT_COMPARED = ("host_data", "device_data_limit_gb", "mxu_precision",
                          "data_parallel", "train_file")


def _literal(text: str):
    import ast

    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def test_recipe_accuracy_runs_the_jax_logs_arguments():
    """The SFNO accuracy run trains with the arguments of the JAX run that
    it is compared with (``logs/train_mc_r4.log``, line 1)."""
    import pathlib

    from tpu_cfd_torch.train import recipe_accuracy

    root = pathlib.Path(__file__).resolve().parents[1]
    first = (root / "logs" / "train_mc_r4.log").read_text().splitlines()[0]
    logged = dict(item.split("=", 1)
                  for item in first.split("Arguments: ", 1)[1].split(" | "))
    ours = vars(train.get_parser().parse_args(
        recipe_accuracy.TRAIN + ["--train-file", "dataset.npz"]))
    compared = [k for k in logged if k in ours and k not in _LOG_KEYS_NOT_COMPARED]
    assert len(compared) >= 30
    differ = {k: (ours[k], logged[k]) for k in compared
              if ours[k] != _literal(logged[k])}
    assert not differ, f"recipe_accuracy.TRAIN differs from the JAX log: {differ}"


def test_recipe_accuracy_fno3d_runs_the_examples_defaults():
    """The FNO3d accuracy run trains at ``examples/ex2_fno3d_train.py``'s
    defaults, read from that script's argument parser."""
    import ast
    import pathlib

    from tpu_cfd_torch.train import recipe_accuracy, train_fno3d

    root = pathlib.Path(__file__).resolve().parents[1]
    tree = ast.parse((root / "examples" / "ex2_fno3d_train.py").read_text())
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw and isinstance(kw["default"], ast.Constant):
                defaults[node.args[0].value.lstrip("-").replace("-", "_")] = \
                    kw["default"].value
    ours = vars(train_fno3d.get_parser().parse_args(
        recipe_accuracy.FNO3D + ["--data-file", "dataset.npz"]))
    compared = [k for k in defaults if defaults[k] is not None]
    assert len(compared) >= 12
    differ = {k: (ours[k], defaults[k]) for k in compared if ours[k] != defaults[k]}
    assert not differ, f"recipe_accuracy.FNO3D differs from the example: {differ}"
