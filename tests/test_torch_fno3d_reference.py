"""The port's FNO3d training CLI (``train/train_fno3d.py`` on its
``--mat-file`` path) against the benchmark's plain FNO-3D reference
(``benchmark/reference/fno3d.py``), on the CPU in float32; neither side
imports JAX.

The port runs as the benchmark's ``train_fno3d`` driver runs it:
``load_windows`` on an ``(N, n, n, T)`` array (``NavierStokesDataset``,
inputs normalised with the train statistics, raw targets), ``build`` with
weights drawn by ``benchmark.inputs.weights``, and ``train_epoch``. The
reference normalises the same trajectories with statistics it computes
itself. Two sizes: a small model (16², 4 → 6 frames, modes 4/4/3, width 8,
b=2) and the published widths (modes 8/8/8, width 20, the 128-wide head) at
32², 10 → 40 frames, b=1. Compared: the forward output, the loss, every
leaf's gradient and every leaf's parameters after 3 Adam steps under the
one-cycle schedule (8 steps in all, so that the 3 cross its peak). Each
tolerance is written with the readings it was set from; the reference with
TF32 operands (the control) fails at least one of them at each size.

Also: the CLI with ``--out-steps`` other than ``--time-steps``; the default
``--out-steps`` giving the CLI's history as it was before the flag; the
model's spans and counters; ``NavierStokesDataset`` on an array.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import inputs  # noqa: E402
from benchmark.reference import fno3d as ref  # noqa: E402
from tpu_cfd_torch.data.datasets import NavierStokesDataset  # noqa: E402
from tpu_cfd_torch.models import fno3d, make_fno3d_input, num_parameters  # noqa: E402
from tpu_cfd_torch.train import train_fno3d  # noqa: E402
from tpu_cfd_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 33 + 29
SIZES = {
    "small": dict(grid_size=16, time_steps=4, out_steps=6, modes=4, modes_t=3, width=8,
                  batch=2, num_samples=8),
    "published_widths_32": dict(grid_size=32, time_steps=10, out_steps=40, modes=8, modes_t=8,
                                width=20, batch=1, num_samples=4),
}
# Readings (program / TF32 control) at both sizes, over seeds 11, 12 and
# this file's: forward max |diff| / max |ref| <= 8.6e-7 / >= 1.5e-3; the
# loss's relative gap <= 1.5e-7 / >= 7.3e-7; a leaf's gradient gap over the
# larger of its norm and the median leaf's <= 3.8e-6 / >= 6.4e-4; a leaf's
# parameters after 3 steps, gap over the larger of its change and the median
# leaf's change, <= 2.9e-4 / >= 1.1e-2.
TOL = {
    # the same operations in another order (F.linear against matmul and
    # add, torch's GELU against its written form): float32 rounding
    "forward": 2e-5,
    # two transforms and two sums of the same fields (the control's loss
    # reads 7.3e-7 to 6.3e-6: it fails by the other readings where it
    # passes this one)
    "loss": 1e-6,
    # the scale keeps leaves whose gradient is a near-cancelling sum (the
    # last block's and the head's biases, through the head's two linear
    # layers: 1e-3 of the median leaf) from reading their rounding as a gap
    "grad": 5e-5,
    # Adam divides each entry's moment by its own root mean square, so the
    # entries of those biases step by about the learning rate whatever
    # their rounding: they read highest (2.9e-4 on head.dense_0.bias)
    "after_3_steps": 2e-3,
}


def _cfg(size: str) -> dict:
    s = SIZES[size]
    return dict(s, num_layers=4, channel_expansion=128, lr=1e-3, epochs=2,
                num_test_samples=2, frames=s["time_steps"] + s["out_steps"] + 2)


def _argv(cfg: dict) -> list:
    return ["--no-cuda", "--num-samples", str(cfg["num_samples"]),
            "--num-test-samples", str(cfg["num_test_samples"]), "--epochs", str(cfg["epochs"]),
            "--batch-size", str(cfg["batch"]), "--lr", str(cfg["lr"]),
            "--modes", str(cfg["modes"]), "--modes-t", str(cfg["modes_t"]),
            "--width", str(cfg["width"]), "--time-steps", str(cfg["time_steps"]),
            "--out-steps", str(cfg["out_steps"]), "--res", str(cfg["grid_size"])]


def _setup(size: str):
    """The port's objects, the seeded weights, the trajectories and the
    reference's normalisation statistics."""
    cfg = _cfg(size)
    n_train = cfg["num_samples"]
    traj = inputs.smooth_trajectories(SEED, 0, n_train + cfg["num_test_samples"],
                                      cfg["grid_size"], cfg["frames"], "cpu").numpy()
    args = train_fno3d.get_parser().parse_args(_argv(cfg))
    (a, u), _, normalizer = train_fno3d.load_windows(args, mat=traj)
    built = train_fno3d.build(args, n_train, normalizer, "cpu")
    params = inputs.weights(ref.param_spec(cfg), SEED, "cpu")
    built.model.load_state_dict(params)
    stats = ref.input_statistics(torch.from_numpy(traj[:n_train, ..., :cfg["time_steps"]]))
    return cfg, built, params, traj, (torch.from_numpy(a), torch.from_numpy(u)), stats


def _ref_batch(cfg, traj, stats, rows):
    t_in, t_out = cfg["time_steps"], cfg["out_steps"]
    batch = torch.from_numpy(traj[np.asarray(rows)])
    return ref.normalize(batch[..., :t_in], stats), batch[..., t_in: t_in + t_out].contiguous()


def _scaled_gaps(got: dict, want: dict, scale: dict) -> dict:
    med = float(np.median(list(scale.values())))
    return {k: float((got[k] - want[k]).norm()) / max(scale[k], med) for k in want}


def _readings(size: str, tf32: bool) -> dict:
    cfg, built, params, traj, (A, U), stats = _setup(size)
    b, t_out = cfg["batch"], cfg["out_steps"]
    order = torch.arange(3 * b).reshape(3, b)

    model = ref.Model(cfg, tf32)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    a_ref, u_ref = _ref_batch(cfg, traj, stats, order[0])
    out_ref = model(p, a_ref)
    loss_ref = ref.sobolev_loss(out_ref, u_ref)
    grad_ref = dict(zip(p, torch.autograd.grad(loss_ref, list(p.values()))))

    out, aux = built.model(make_fno3d_input(A[order[0]], t_out))
    assert aux is None and out.shape == out_ref.shape == (b, cfg["grid_size"],
                                                          cfg["grid_size"], t_out)
    loss = built.loss_fn((out, aux), U[order[0]])
    loss.backward()
    grad = {k: v.grad for k, v in built.model.named_parameters()}
    assert grad.keys() == grad_ref.keys()

    batches = [_ref_batch(cfg, traj, stats, rows) for rows in order]
    _, _, after_ref = ref.train(params, batches, cfg, built.steps_per_epoch, tf32=tf32)
    built.model.zero_grad()
    losses = train_fno3d.train_epoch(built, A, U, order)
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    after = {k: v.detach() for k, v in built.model.named_parameters()}
    change = {k: float((after_ref[k] - params[k]).norm()) for k in params}
    return {
        "forward": float((out.detach() - out_ref.detach()).abs().max()
                         / out_ref.detach().abs().max()),
        "loss": abs(float(loss.detach()) - float(loss_ref.detach())) / float(loss_ref.detach()),
        "grad": max(_scaled_gaps(grad, grad_ref,
                                 {k: float(g.norm()) for k, g in grad_ref.items()}).values()),
        "after_3_steps": max(_scaled_gaps(after, after_ref, change).values()),
    }


@pytest.mark.parametrize("size", list(SIZES))
def test_the_port_matches_the_plain_reference(size):
    got = _readings(size, tf32=False)
    assert all(got[k] <= TOL[k] for k in TOL), (got, TOL)


@pytest.mark.parametrize("size", list(SIZES))
def test_the_tf32_control_fails_a_tolerance(size):
    got = _readings(size, tf32=True)
    assert any(got[k] > TOL[k] for k in TOL), (got, TOL)


def _param_formula(t_in: int, width: int, modes: int, modes_t: int, layers: int = 4,
                   head: int = 128) -> int:
    """The lift, the spectral weights (4 corner blocks of complex pairs),
    each block's MLP and skip, and the head."""
    w = width
    return ((t_in + 3) * w + w + layers * (4 * modes * modes * modes_t * w * w * 2)
            + layers * 2 * (w * w + w) + layers * (w * w + w) + (w * head + head) + head + 1)


def test_param_formula_at_the_published_widths():
    assert _param_formula(10, 20, 8, 8) == ref.n_params(dict(
        time_steps=10, width=20, modes=8, modes_t=8, num_layers=4,
        channel_expansion=128)) == 6_561_737
    assert _param_formula(10, 10, 32, 5) == 16_386_997  # the CLI's defaults


CLI = ["--no-cuda", "--num-samples", "6", "--num-test-samples", "2", "--epochs", "2",
       "--batch-size", "2", "--modes", "4", "--modes-t", "3", "--width", "4", "--res", "16"]


def _mat_file(tmp_path, frames: int) -> Path:
    u = inputs.smooth_trajectories(7, 0, 8, 16, frames, "cpu").numpy()
    path = tmp_path / "ns.npz"
    np.savez(path, u=u)
    return path


def test_cli_with_out_steps(tmp_path):
    path = _mat_file(tmp_path, 12)
    out = train_fno3d.main([*CLI, "--mat-file", str(path), "--time-steps", "4",
                            "--out-steps", "6"])
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert np.isfinite([h["train"] for h in hist] + [h["test"] for h in hist]).all()
    assert out["n_params"] == num_parameters(out["model"]) == _param_formula(4, 4, 4, 3)
    pred, _ = out["model"](make_fno3d_input(torch.zeros(3, 16, 16, 4), 6))
    assert pred.shape == (3, 16, 16, 6)


# the CLI's history on _mat_file(12) with CLI and --time-steps 5, read from
# the CLI as it was before it took --out-steps (torch 2.13 on the CPU); the
# tolerance leaves room for another CPU's summation order
BEFORE = {"n_params": 25_621,
          "history": [(0.458878755569458, 0.4518328011035919),
                      (0.45021912455558777, 0.44909340143203735)]}


def test_default_out_steps_keeps_the_cli_as_it_was(tmp_path):
    path = _mat_file(tmp_path, 12)
    argv = [*CLI, "--mat-file", str(path), "--time-steps", "5"]
    default = train_fno3d.main(argv)
    explicit = train_fno3d.main([*argv, "--out-steps", "5"])
    assert default["history"] == explicit["history"]
    assert default["n_params"] == BEFORE["n_params"] == _param_formula(5, 4, 4, 3)
    got = [(h["train"], h["test"]) for h in default["history"]]
    assert np.allclose(got, BEFORE["history"], rtol=1e-4, atol=0)


def test_fixed_window_guard_counts_input_and_output_steps(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "traj.npz"
    np.savez(path, vorticity=rng.standard_normal((10, 14, 16, 16)).astype(np.float32))
    argv = [*CLI, "--data-file", str(path), "--t-start", "2", "--time-steps", "4"]
    out = train_fno3d.main([*argv, "--out-steps", "8"])  # 2 + 4 + 8 = 14 records
    assert len(out["history"]) == 2
    with pytest.raises(ValueError, match="plus 4 input and 9 output steps"):
        train_fno3d.main([*argv, "--out-steps", "9"])


def test_spans_and_counters_of_a_forward():
    model = fno3d.FNO3d(4, 4, 3, width=8, input_channel=4)
    x = make_fno3d_input(torch.randn(2, 16, 16, 4), 6)
    plain, _ = model(x)
    fno3d.reset_counts()
    assert fno3d.COUNTS == {"forwards": 0, "conv_calls": 0, "conv_points": 0}
    profiling.clear_span_log()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced, _ = model(x)
    names = [name for name, *_ in profiling.span_log()]
    assert sorted(set(names)) == ["fno3d.conv", "fno3d.head", "fno3d.mlp"]
    assert [names.count(n) for n in ("fno3d.conv", "fno3d.mlp", "fno3d.head")] == [4, 4, 1]
    assert fno3d.COUNTS == {"forwards": 1, "conv_calls": 4, "conv_points": 4 * 2 * 16 * 16 * 6}
    assert torch.equal(plain, traced)
    profiling.clear_span_log()


def test_train_epoch_spans_its_inputs():
    cfg, built, _, _, (A, U), _ = _setup("small")
    order = torch.arange(4).reshape(2, 2)
    profiling.clear_span_log()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        train_fno3d.train_epoch(built, A, U, order)
    names = [name for name, *_ in profiling.span_log()]
    assert names.count("fno3d.input") == 2 and names.count("train.forward") == 2
    assert names.count("fno3d.conv") == 8
    profiling.clear_span_log()


def test_navier_stokes_dataset_takes_an_array(tmp_path):
    u = inputs.smooth_trajectories(3, 0, 6, 8, 9, "cpu").numpy()
    path = tmp_path / "ns.npz"
    np.savez(path, u=u)
    kw = dict(n_samples=4, time_steps_input=3, time_steps_output=5)
    for train in (True, False):
        a, b = (NavierStokesDataset(src, train=train, **kw) for src in (path, u))
        assert np.array_equal(a.a, b.a) and np.array_equal(a.u, b.u)
        assert a.u.shape == (4, 8, 8, 5)


@pytest.mark.cuda
def test_the_test_pass_on_the_card_replays_the_eager_losses():
    """On the card ``evaluate`` replays the test pass as one CUDA graph: its
    mean equals the eager per-sample losses' bit for bit, after training
    steps too (the graph reads the parameters in place), a replay moves no
    counter of the model, and other test tensors are captured anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m cuda "
                    "tests/test_torch_fno3d_reference.py --noconftest)")
    cfg = _cfg("published_widths_32")
    traj = inputs.smooth_trajectories(SEED, 0, 8, cfg["grid_size"], cfg["frames"], "cuda")
    args = train_fno3d.get_parser().parse_args(
        _argv(dict(cfg, num_samples=6, num_test_samples=2))[1:])
    (a, u), (at, ut), normalizer = train_fno3d.load_windows(args, mat=traj.cpu().numpy())
    A, U, At, Ut = (torch.from_numpy(x).cuda() for x in (a, u, at, ut))
    built = train_fno3d.build(args, 6, normalizer, "cuda")

    def eager(At=At, Ut=Ut):
        with torch.no_grad():
            return torch.stack([train_fno3d.sample_loss(built, At[i:i + 1], Ut[i:i + 1])
                                for i in range(At.shape[0])]).mean()

    for rows in ([[0], [1]], [[2]]):
        train_fno3d.train_epoch(built, A, U, torch.tensor(rows, device="cuda"))
        graphed = train_fno3d.evaluate(built, At, Ut)
        assert built.test_graph is not None
        assert torch.equal(graphed, eager()), (float(graphed), float(eager()))
    counts, graph = dict(fno3d.COUNTS), built.test_graph
    train_fno3d.evaluate(built, At, Ut)
    assert fno3d.COUNTS == counts and built.test_graph is graph
    At2, Ut2 = At.flip(0).contiguous(), Ut.flip(0).contiguous()
    assert torch.equal(train_fno3d.evaluate(built, At2, Ut2), eager(At2, Ut2))
    assert built.test_graph is not graph
