"""The port's Spectral-Refiner fine-tune against the benchmark's plain
reference (``benchmark/reference/refiner.py``), on the CPU in fp64.

The port runs as the benchmark's ``refine`` driver and the example run it:
``ex2_sfno_finetune``'s ``build_sfno``, ``zero_shot``, ``build_outconv``,
``make_forcing``, ``residual_norm``, and ``finetune.finetune_steps``, at
32² with b = 2, 4 output steps, an SFNO at modes 4/4/3 and width 6, the
enlarged conv at 8/8/3, on weights and frames made from a seed. Compared:
the reduced latent ``r`` and the zero-shot prediction; ``fine_tune_post``'s
w, w_t and residual, the residual norm and its gradient by parameter (at dt
1e-3, as the parity tests against the JAX package take it: with the
symmetric BDF weights the residual is O(dt²), and at dt 1e-6 it sits at
the rounding floor over dt); and a 3-iteration refine at the example's dt
1e-6: its history and the trajectory of its last iterate (the kept one is
left out: which iterate has the least residual at the rounding floor is
luck, and an fp32 run that keeps its first iterate would come out as close
to the program as a second fp64 run). Neither side imports JAX.

Each tolerance is written with the reading it was set from. The reference in
fp32 fails every one (``test_the_fp32_reference_fails_each_tolerance``).
The spans of ``train/finetune.py`` leave every result bitwise equal under a
profiler, and its counters count the iterations and the keep-best copies.
The example's ``main`` gives the history its steps gave before they were
factored into functions.
"""

import glob
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import inputs  # noqa: E402
from benchmark.reference import refiner as ref  # noqa: E402
from benchmark.reference import sfno as ref_sfno  # noqa: E402
from tpu_cfd_torch.data.datasets import SpatioTemporalDataset  # noqa: E402
from tpu_cfd_torch.examples import ex2_sfno_finetune as example  # noqa: E402
from tpu_cfd_torch.models import SFNO, forward_with_latents  # noqa: E402
from tpu_cfd_torch.train import finetune, losses, pipeline  # noqa: E402
from tpu_cfd_torch.utils import profile_to  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 33 + 25
N, B, T_OUT = 32, 2, 4
SMALL = dict(example.CONFIGS["fno"], modes=4, modes_t=3, width=6, out_steps=T_OUT, iters=3)
CFG = dict(SMALL, channel_expansion=4, num_layers=4, latent_steps=10, delta=0.1,
           modes_ft=[8, 8, 3], delta_ft=example.FT_KWS["delta"],
           ft_dt=example.FT_KWS["dt"], viscosity=example.FT_KWS["visc"],
           bdf_weight=list(example.FT_KWS["bdf_weight"]),
           residual_alpha=example.RESIDUAL_ALPHA, forcing_scale=0.1, forcing_wave_number=1,
           lr_weight=example.LR_WEIGHT)
DT_GRAD = 1e-3

# the latent r and the zero-shot prediction: the port reads 2.3e-16 and
# 8.0e-17, the fp32 reference 2.1e-7 and 3.6e-8
TOL_ZERO_SHOT = 1e-13
# fine_tune_post at dt 1e-3, each field's worst-sample distance relative to
# its own norm (w_t's for the residual, a small difference of w_t and the
# terms of the equation): w 3.1e-16, w_t 2.5e-15, residual 2.5e-15; the fp32
# reference 1.8e-7, 1.9e-5 and 1.9e-5
TOL_POST = {"w": 1e-13, "w_t": 1e-13, "residual": 1e-13}
# the residual norm at dt 1e-3: 1.5e-12 relative; fp32 4.8
TOL_NORM = 1e-10
# each parameter's gradient at dt 1e-3, the largest difference over the
# leaf's largest entry: 7.6e-12 to 6.3e-11; fp32 0.40 to 7.4
TOL_GRAD = 1e-8
# the history at dt 1e-6: its first entry (no update yet) 1.2e-6 relative;
# after an update the two part, as the residual sits at the rounding floor
# over dt and Adam follows its gradient there: 0.20 (0.53 in a run with
# other frames); fp32 reads 2.7e8 from the first entry on
TOL_FIRST = 1e-5
TOL_HISTORY = 3.0
# the last iterate's trajectory after 3 iterations, the worst sample:
# 4.0e-6; fp32 8.2e-4
TOL_REFINED = 1e-4


def _rel(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor = None) -> float:
    """The worst sample's L2 distance relative to ``scale``'s (``want``'s)."""
    scale = want if scale is None else scale
    got, want, scale = (t.detach().double().flatten(1) for t in (got, want, scale))
    return float(((got - want).norm(dim=1) / scale.norm(dim=1)).max())


def _params(dtype=torch.float32):
    return inputs.weights(ref_sfno.param_spec(CFG), SEED, "cpu", dtype)


def _frames(dtype=torch.float64):
    return 3 * inputs.smooth_trajectories(SEED, 0, B, N, SMALL["steps"], "cpu", dtype)


def _port():
    """The example's SFNO on the seed's weights, in fp64."""
    model = example.build_sfno(SMALL)
    model.load_state_dict(_params())
    return model.to(torch.float64)


def _ref_params(dtype=torch.float64):
    return {k: v.to(dtype) for k, v in _params().items()}


def _port_post(out_conv, r, x, dt):
    out_conv.dt = dt
    f = example.make_forcing("sincos", N, torch.float64, "cpu")
    return out_conv(r, x, f, out_steps=T_OUT)


def _ref_post(p0, r, x, dt, dtype=torch.float64):
    cfg = dict(CFG, ft_dt=dt)
    f = ref.forcing(N, cfg, dtype, "cpu")
    return ref.post(ref.out_conv(p0, r, x, cfg), f, cfg)


def _ref_run(dtype):
    """The reference's readings in ``dtype``: the latent, the prediction,
    the post-process and norm and gradients at dt 1e-3, the 3-iteration
    history and refined trajectory at dt 1e-6."""
    p = _ref_params(dtype)
    x = _frames().to(dtype)
    with ref.no_tf32():
        pred, r = ref.zero_shot(p, x, CFG)
        p0 = ref.initial_ft_params(p, CFG)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        out = _ref_post(leaves, r, x, DT_GRAD, dtype)
        norm = ref.residual_norm(out["residual"], CFG)
        grads = dict(zip(leaves, torch.autograd.grad(norm, list(leaves.values()))))
    run = ref.refine(p0, r, x, CFG, keep_best=False)
    return {"r": r, "pred": pred, "post": out, "norm": float(norm.detach()), "grads": grads,
            "history": run["history"], "refined": run["refined"]}


@pytest.fixture(scope="module")
def port():
    model = _port()
    x = _frames()
    pred, r = example.zero_shot(model, x, T_OUT)
    out_conv = example.build_outconv(model, SMALL, CFG["modes_ft"], torch.float64, "cpu")
    out = _port_post(out_conv, r, x, DT_GRAD)
    norm = example.residual_norm(N, SMALL["diam"])(out["residual"])
    named = dict(out_conv.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(norm, list(named.values()))))
    out_conv = example.build_outconv(model, SMALL, CFG["modes_ft"], torch.float64, "cpu")
    f = example.make_forcing("sincos", N, torch.float64, "cpu")
    # the example's refine without its keep-best: the last iterate
    hist = finetune.finetune_steps(
        out_conv, r, x, f, out_steps=T_OUT, n_steps=SMALL["iters"], lr=example.LR_WEIGHT,
        lr_bias=SMALL["lr_bias"], residual_norm=example.residual_norm(N, SMALL["diam"]),
        keep_best=False)
    with torch.no_grad():
        refined = out_conv(r, x, out_steps=T_OUT, original=True)
    return {"r": r, "pred": pred, "post": {k: v.detach() for k, v in out.items()},
            "norm": float(norm.detach()), "grads": grads, "history": hist,
            "refined": refined}


@pytest.fixture(scope="module")
def reference():
    return _ref_run(torch.float64)


@pytest.fixture(scope="module")
def reference_fp32():
    return _ref_run(torch.float32)


def _readings(got: dict, want: dict) -> dict:
    """Every compared number: name -> (reading, tolerance)."""
    out = {"r": (_rel(got["r"], want["r"]), TOL_ZERO_SHOT),
           "pred": (_rel(got["pred"], want["pred"]), TOL_ZERO_SHOT),
           "norm": (abs(got["norm"] - want["norm"]) / want["norm"], TOL_NORM)}
    for k, tol in TOL_POST.items():
        scale = want["post"]["w_t" if k == "residual" else k]
        out[f"post.{k}"] = (_rel(got["post"][k], want["post"][k], scale), tol)
    for name, g in want["grads"].items():
        diff = (got["grads"][name].double() - g.double()).abs().max()
        out[f"grad.{name}"] = (float(diff / g.double().abs().max()), TOL_GRAD)
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["history"], want["history"])]
    out["history.first"] = (gaps[0], TOL_FIRST)
    out["history"] = (max(gaps), TOL_HISTORY)
    out["refined"] = (_rel(got["refined"], want["refined"]), TOL_REFINED)
    return out


CHECKS = ["r", "pred", "norm", "post.w", "post.w_t", "post.residual", "grads",
          "history.first", "history", "refined"]


def _pick(readings: dict, check: str) -> list:
    if check == "grads":
        return [v for k, v in readings.items() if k.startswith("grad.")]
    return [readings[check]]


@pytest.mark.parametrize("check", CHECKS)
def test_port_matches_reference(port, reference, check):
    readings = _readings(port, reference)
    assert len(port["history"]) == len(reference["history"]) == SMALL["iters"]
    for value, tol in _pick(readings, check):
        assert value <= tol, (check, value)


@pytest.mark.parametrize("check", CHECKS)
def test_the_fp32_reference_fails_each_tolerance(reference, reference_fp32, check):
    readings = _readings(reference_fp32, reference)
    for value, tol in _pick(readings, check):
        assert value > tol, (check, value)


def test_the_batch_norm_is_the_mean_of_each_samples():
    """``residual_norm`` reduces over the batch by the mean of each sample's
    norm, the reduction that ``finetune_steps`` under a mesh assumes."""
    res = torch.randn((3, N, N, T_OUT), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    norm = example.residual_norm(N, SMALL["diam"])
    each = torch.stack([norm(res[i: i + 1]) for i in range(3)])
    assert float(norm(res)) == pytest.approx(float(each.mean()), rel=1e-14)
    assert float(ref.residual_norm(res, CFG)) == pytest.approx(float(norm(res)), rel=1e-13)


def _steps(out_conv, r, x, iters=3):
    f = example.make_forcing("sincos", N, torch.float64, "cpu")
    hist = finetune.finetune_steps(
        out_conv, r, x, f, out_steps=T_OUT, n_steps=iters, lr=example.LR_WEIGHT,
        lr_bias=SMALL["lr_bias"], residual_norm=example.residual_norm(N, SMALL["diam"]))
    return hist, {k: v.clone() for k, v in out_conv.state_dict().items()}


def test_spans_leave_results_bitwise_equal_and_counters_count(tmp_path):
    model = _port()
    x = _frames()
    _, r = example.zero_shot(model, x, T_OUT)
    finetune.reset_counts()
    plain = _steps(example.build_outconv(model, SMALL, CFG["modes_ft"]), r, x)
    assert finetune.COUNTS["iterations"] == 3
    assert 1 <= finetune.COUNTS["best_copies"] <= 3
    with profile_to(str(tmp_path)):
        traced = _steps(example.build_outconv(model, SMALL, CFG["modes_ft"]), r, x)
    assert finetune.COUNTS["iterations"] == 6
    assert plain[0] == traced[0]
    for k, v in plain[1].items():
        assert torch.equal(v, traced[1][k]), k
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    # 3 iterations and the keep-best evaluation: 4 forwards and post-processes
    assert {k: names.count(k) for k in ("ft.forward", "ft.post", "ft.backward",
                                         "ft.optimizer", "ft.record")} == {
        "ft.forward": 4, "ft.post": 4, "ft.backward": 3, "ft.optimizer": 3, "ft.record": 4}


def test_main_gives_the_history_of_its_steps(tmp_path):
    """``main`` (``--example fno``, 32², the enlarged conv at 16/16/6, 3
    iterations, ``--no-cuda``) on a toy checkpoint and a test file made
    here gives the history of the steps it took before they were factored
    out, written out here as they were."""
    cfg = example.CONFIGS["fno"]
    steps, out_steps = cfg["steps"], cfg["out_steps"]
    traj = 3 * inputs.smooth_trajectories(SEED, 1, 2, N, steps + out_steps + 2, "cpu",
                                          torch.float64)
    path = tmp_path / "test.npz"
    np.savez(path, vorticity=traj.permute(0, 3, 1, 2).numpy())
    model = SFNO(modes_x=cfg["modes"], modes_y=cfg["modes"], modes_t=cfg["modes_t"],
                 width=cfg["width"], beta=cfg["beta"], output_steps=out_steps)
    model.load_state_dict(inputs.weights(ref_sfno.param_spec(dict(
        cfg, channel_expansion=4, num_layers=4)), SEED, "cpu", torch.float32))
    ckpt = pipeline.save_checkpoint(model, tmp_path / "sfno")[:-3]
    result = example.main(["--example", "fno", "--res", str(N), "--modes-ft", "16", "16", "6",
                           "--t-start", "1", "--idx", "1", "--ckpt", ckpt, "--test-file",
                           str(path), "--iters", "3", "--no-cuda"])

    # the steps as main took them
    ds = SpatioTemporalDataset(str(path), n_samples=16, fields=["vorticity"], steps=steps,
                               out_steps=out_steps, T_start=1, train=False, dtype=np.float64)
    inp, out = ds.sample(np.array([1]))
    w_in, w_gt = torch.from_numpy(inp["vorticity"]), torch.from_numpy(out["vorticity"])
    model = SFNO(modes_x=cfg["modes"], modes_y=cfg["modes"], modes_t=cfg["modes_t"],
                 width=cfg["width"], beta=cfg["beta"], output_steps=out_steps)
    pipeline.load_checkpoint(ckpt, model)
    model.to(dtype=torch.float64)
    l2_rel = losses.SobolevLoss(n_grid=N, norm_order=0, time_average=True, relative=True,
                                diam=cfg["diam"], freq_cutoff=N // 2 + 1)
    with torch.no_grad():
        pred_no, latents = forward_with_latents(model, w_in, out_steps=out_steps)
    qft = finetune.build_finetune_outconv(
        model.out_conv.conv, (cfg["modes"], cfg["modes"], cfg["modes_t"]), (16, 16, 6),
        out_steps=out_steps, generator=torch.Generator().manual_seed(1),
        dtype=torch.float64, device=None, delta=1.0, diam=cfg["diam"], visc=1e-3, dt=1e-6,
        bdf_weight=(0.5, 0.5), temporal_padding=True, finetune=True)
    res_hm1 = losses.SobolevLoss(n_grid=N, norm_order=-1, relative=False, time_average=True,
                                 alpha=10 ** (-3 / 2), freq_cutoff=N // 2 + 1, diam=cfg["diam"])
    f = example.make_forcing("sincos", N, torch.float64, "cpu")
    hist = finetune.finetune_steps(
        qft, latents["r"], w_in, f, out_steps=out_steps, n_steps=3, lr=1e-4,
        lr_bias=cfg["lr_bias"], residual_norm=res_hm1,
        track=lambda o: {"l2_vs_gt": l2_rel(o["w"], w_gt), "l2_vs_noft": l2_rel(o["w"], pred_no)})
    assert result["zero_shot_rel_l2"] == float(l2_rel(pred_no, w_gt))
    assert result["history"] == hist
    assert len(hist) == 4 and result["best"] == min(h["residual"] for h in hist)
