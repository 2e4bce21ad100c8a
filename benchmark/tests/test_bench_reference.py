"""The plain references against the port at small sizes on the CPU, the
inputs made from the seed, and the work counts against hand-worked values."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import mcwilliams as rm
from benchmark.reference import sfno as rs
from benchmark.reference.precision import to_tf32
from benchmark.work import fft_flops
from benchmark.work import mcwilliams256 as work_gen
from benchmark.work import sfno_mcwilliams as work_sfno

SMALL_SFNO = dict(width=4, channel_expansion=4, modes=4, modes_t=3, num_layers=3,
                  latent_steps=6, out_time_steps=6, time_steps=6, beta=0.0, delta=0.1,
                  epochs=2, lr=1e-2, grid_size=16)


def _port_sfno(cfg):
    from tpu_cfd_torch.models import SFNO

    return SFNO(modes_x=cfg["modes"], modes_y=cfg["modes"], modes_t=cfg["modes_t"],
                width=cfg["width"], beta=cfg["beta"], num_spectral_layers=cfg["num_layers"],
                output_steps=cfg["out_time_steps"], activation="GELU",
                latent_steps=cfg["latent_steps"])


@pytest.mark.parametrize("modes", [4, 8])
def test_sfno_forward_and_loss_match_the_port(modes):
    from tpu_cfd_torch.train import losses

    cfg = dict(SMALL_SFNO, modes=modes)
    model = _port_sfno(cfg)
    spec = rs.param_spec(cfg)
    assert [s[0] for s in spec] == [n for n, _ in model.named_parameters()]
    params = inputs.weights(spec, 3, "cpu")
    g = torch.Generator().manual_seed(0)
    # biases and norm parameters away from their initial values, so that each
    # enters the comparison
    params = {k: v + (0.1 * torch.randn(v.shape, generator=g) if kind in ("zeros", "ones") else 0)
              for (k, v), (_, _, kind, _) in zip(params.items(), spec)}
    model.load_state_dict(params)
    x, y = torch.randn(2, 16, 16, 6, generator=g), torch.randn(2, 16, 16, 6, generator=g)
    out, ref = model(x), rs.Model(cfg)(params, x)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    loss = losses.SobolevLoss(n_grid=16, norm_order=0, relative=True)
    assert rs.sobolev_loss(ref, y).item() == pytest.approx(loss(out, y).item(), rel=1e-5)


@pytest.mark.parametrize("before", [0, 2])
def test_sfno_train_steps_match_the_port(before):
    """Three Adam steps under the one-cycle schedule through the port's
    device epoch, against the reference's from the same weights, Adam state
    and windows: from the start, and after ``before`` steps of the port."""
    from tpu_cfd_torch.train import losses, pipeline

    cfg = dict(SMALL_SFNO)
    model = _port_sfno(cfg)
    model.load_state_dict(inputs.weights(rs.param_spec(cfg), 4, "cpu"))
    data = inputs.smooth_trajectories(4, 0, 12, 16, 20, "cpu")
    idx, starts = inputs.epoch_indices(12, 20, 12, 2, np.random.default_rng(1))
    opt = pipeline.get_optimizer("Adam", model.parameters(), cfg["lr"])
    sched = pipeline.onecycle_lr(opt, cfg["lr"], 4, cfg["epochs"])
    run = pipeline.make_device_epoch(model, losses.SobolevLoss(n_grid=16, norm_order=0,
                                                               relative=True),
                                     opt, data, 6, 6, sched)
    run(idx[:before], starts[:before])
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = {key: {n: opt.state[p][key].clone() for n, p in zip(names, model.parameters())
                   if p in opt.state} for key in ("exp_avg", "exp_avg_sq")}
    state.update(step=before, lr_step=sched.last_epoch)
    got = run(idx[before: before + 3], starts[before: before + 3])
    batches = [rs.gather(data, idx[i], starts[i], 6, 6) for i in range(before, before + 3)]
    want, grads, after = rs.train(params, batches, cfg, 4, state=state)
    assert got.tolist() == pytest.approx(want, rel=1e-5)
    for name, p in model.named_parameters():
        moved = (after[name] - params[name]).norm()
        assert (p.detach() - after[name]).norm() <= 1e-3 * moved + 1e-9, name


def test_onecycle_matches_the_port():
    from tpu_cfd_torch.train import pipeline

    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=1e-2)
    sched = pipeline.onecycle_lr(opt, 1e-2, 288, 15)
    for step in range(4400):
        assert opt.param_groups[0]["lr"] == pytest.approx(rs.onecycle(step, 1e-2, 4320),
                                                          rel=1e-12)
        opt.step()
        sched.step()


def test_epoch_indices_match_the_port_dataset():
    from tpu_cfd_torch.data.datasets import SpatioTemporalDataset

    data = {"vorticity": np.zeros((12, 30, 4, 4), np.float32)}
    ds = SpatioTemporalDataset(data, n_samples=12, fields=["vorticity"], steps=5, out_steps=5)
    a = ds.epoch_indices(4, np.random.default_rng(7))
    b = inputs.epoch_indices(12, 30, 10, 4, np.random.default_rng(7))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_mcwilliams_ic_matches_the_port_in_fp64():
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.solvers import initial_conditions as ic

    n = 32
    grid = grids.Grid((n, n), domain=((0, 2 * math.pi), (0, 2 * math.pi)))
    noise = torch.randn(3, n, n, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    port = ic.vorticity_field(grid, 4, dtype=torch.float64, noise=noise).data
    ref = rm.initial_vorticity(noise, 2 * math.pi, 4)
    assert (port - ref).abs().max() <= 1e-12 * ref.abs().max()


def test_subsample_matches_antialiased_bilinear():
    f = torch.randn(3, 64, 64, dtype=torch.float64)
    a = torch.as_tensor(rm.subsample_matrix(64, 16))
    want = F.interpolate(f[:, None], size=(16, 16), mode="bilinear", align_corners=False,
                         antialias=True)[:, 0]
    assert (a @ f @ a.T - want).abs().max() <= 1e-12


@pytest.mark.parametrize("impl,fused,dealias", [("dft_galerkin", True, "galerkin"),
                                                ("dft_galerkin", False, "galerkin"),
                                                ("fft", False, "nonlinear")])
def test_mcwilliams_records_match_the_port_pipeline(impl, fused, dealias):
    """The port's batch pipeline (the fused kernel's plain version on the
    CPU) against the reference with the route's dealiasing: the Galerkin
    block, or every mode kept on ``torch.fft``."""
    from tpu_cfd_torch import grids
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.solvers import initial_conditions as ic
    from tpu_cfd_torch.solvers.equations import NavierStokes2DSpectral

    n = 32
    cfg = dict(grid_size=n, subsample=4, domain=2 * math.pi, viscosity=1e-3, dt=1e-3,
               peak_wavenumber=4, warmup_steps=10, recorded_steps=20, record_every=5,
               dealias=dealias)
    grid = grids.Grid((n, n), domain=((0, 2 * math.pi), (0, 2 * math.pi)))
    noise = inputs.batch_noise(5, 0, (2, n, n), torch.float32, "cpu")
    w0 = ic.vorticity_field(grid, 4, noise=noise).data
    ns2d = NavierStokes2DSpectral(viscosity=1e-3, grid=grid, fft_impl=impl, fused=fused,
                                  device="cpu")
    pipe = generate.make_batch_pipeline(ns2d, 1e-3, 10, 20, 5, n // 4)
    got = torch.as_tensor(pipe(torch.fft.rfft2(w0))["vorticity"])
    want = rm.records(noise, cfg)
    assert got.shape == want.shape == (2, 4, 8, 8)
    rel = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    assert rel.max() < 1e-4
    assert rm.solver_steps(cfg) == 10 + 1 + 3 * 5


def test_the_tf32_control_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 + 2 ** -12])
    assert to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]
    z = torch.complex(x, -x)
    assert torch.equal(to_tf32(z).real, to_tf32(x))


def test_inputs_repeat_for_a_seed_and_differ_between_seeds():
    big = 2 ** 31 + 12345
    a = inputs.batch_noise(big, 3, (4, 8), torch.float32, "cpu")
    assert torch.equal(a, inputs.batch_noise(big, 3, (4, 8), torch.float32, "cpu"))
    assert not torch.equal(a, inputs.batch_noise(big + 1, 3, (4, 8), torch.float32, "cpu"))
    assert not torch.equal(a, inputs.batch_noise(big, 4, (4, 8), torch.float32, "cpu"))
    d = inputs.smooth_trajectories(big, 0, 3, 8, 10, "cpu", chunk=2)
    assert d.shape == (3, 8, 8, 10)
    assert d.flatten(1).std(dim=1).tolist() == pytest.approx([1.0] * 3, rel=1e-4)
    w = inputs.weights(rs.param_spec(SMALL_SFNO), big, "cpu")
    assert w["lifting.norm.scale"].eq(1).all() and w["reduce.bias"].eq(0).all()
    std = w["ffns.0.dense_0.weight"].std().item()
    assert 0.2 < std < 0.6  # 1/sqrt(4), clipped at two standard deviations


def test_work_counts_by_hand():
    assert fft_flops(8) == 2.5 * 8 * 3
    # n = 8: 5 transforms of 64 points (960 each), 3 x 64 for the product,
    # 20 x 12 kept modes (4 x modes of 8, 3 y modes of 5); 5 stages
    assert work_gen.kept_modes(8) == 12
    assert work_gen.sample_step_flops({"grid_size": 8}) == 5 * (5 * 960 + 192 + 240)
    assert work_gen.kept_modes(256) == 170 * 86
    # width 1, expansion 2, 4x4 grid, 2 steps in and out, modes 1/1/1, two
    # layers, batch 1: lifting dense 64, lifting conv 2 x 400 + 32, the two
    # FFNs 256 each, the backbone conv 832 and skip 64, reduction 64, the
    # output conv on 6 padded steps 2 x 1580.39 + 32, the loss 4 x 160
    cfg = dict(grid_size=4, time_steps=2, latent_steps=2, out_time_steps=2, width=1,
               channel_expansion=2, modes=1, modes_t=1, num_layers=2)
    out_fft = 2.5 * 96 * math.log2(96)
    want = 64 + 832 + 256 + (832 + 256 + 64) + 64 + (2 * out_fft + 32) + 640
    assert work_sfno.forward_flops(cfg, 1) == pytest.approx(want)
    params = sum(math.prod(s) for _, s, _, _ in rs.param_spec(cfg))
    assert work_sfno.step_flops(cfg, 1) == pytest.approx(3 * want + 12 * params)
    recipe = {k: v for k, v in SMALL_SFNO.items()}
    recipe.update(width=10, modes=32, modes_t=5, num_layers=4, latent_steps=10,
                  time_steps=10, out_time_steps=10, grid_size=64)
    assert sum(math.prod(s) for _, s, _, _ in rs.param_spec(recipe)) == 16469791
