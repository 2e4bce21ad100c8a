"""The port's McWilliams dataset generation against the JAX package.

Shared inputs go through both ``make_batch_pipeline``s (warmup, chunked
rollout, irfft2 and the antialiased bilinear subsample): fp64 records to
rtol 1e-9 (the JAX suite's transform tolerance), fp32 records to 1e-5 of
their largest magnitude (fp32 roundoff over a few steps). The CLI runs here
with ``--no-cuda`` at 32² and writes the npz part/meta format that
``tpu_cfd.data.datasets.load_trajectory_dict`` reads.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import grids as jgrids
from tpu_cfd.data import datasets as jdatasets, generate as jgen
from tpu_cfd.solvers import equations as jeq, forcings as jforcings
from tpu_cfd_torch import grids as tgrids
from tpu_cfd_torch.data import generate as tgen
from tpu_cfd_torch.solvers import equations as teq, forcings as tforcings

torch.set_num_threads(2)

N = 32
DT = 1e-3
DOMAIN = ((0, 2 * np.pi), (0, 2 * np.pi))


def _fields(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("n,ns", [(64, 16), (64, 32), (32, 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_subsample_matches_jax_image_resize(n, ns, dtype):
    x = _fields((2, 3, n, n), dtype)
    ref = np.asarray(jgen._subsample_field(jnp.asarray(x), ns))
    ours = tgen._subsample_field(torch.from_numpy(x), ns).numpy()
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * np.abs(ref).max())
    assert tgen._subsample_field(torch.from_numpy(x), n).shape == x.shape


def _spectrum(batch, dtype):
    x = _fields((batch, N, N), np.float64, 1)
    k = np.sqrt(np.fft.fftfreq(N)[:, None] ** 2 + np.fft.rfftfreq(N)[None] ** 2) * N
    xh = np.fft.rfft2(x) * 20 * np.exp(-((k / 4) ** 2))
    return xh.astype(np.complex128 if dtype == np.float64 else np.complex64)


def _flow(case, grid, forcings, equations):
    """The forcing, drag and integrator of each dataset CLI's flow."""
    if case == "kolmogorov":  # main_kolmogorov: velocity forcing, drag 0.1, RK4-CN
        forcing = forcings.KolmogorovForcing(grid=grid, scale=1.0, wave_number=4,
                                             diam=2 * np.pi, vorticity=False)
        return dict(forcing_fn=forcing, drag=0.1)
    if case == "fno":  # main_fno: vorticity forcing, IMEX order 2
        forcing = forcings.SinCosForcing(grid=grid, scale=0.1, diam=2 * np.pi,
                                         wave_number=1, vorticity=True)
        return dict(forcing_fn=forcing, solver=equations.IMEXStepper(order=2))
    return {}


@pytest.mark.parametrize("impl,dtype,fields,case", [
    ("fft", np.float64, ("vorticity", "stream", "vort_t", "residual"), "mcwilliams"),
    ("dft_galerkin", np.float32, ("vorticity",), "mcwilliams"),
    ("dft_aligned", np.float32, ("vorticity", "vort_t"), "mcwilliams"),
    ("dft_galerkin", np.float32, ("vorticity", "vort_t"), "kolmogorov"),
    ("fft", np.float64, ("vorticity", "stream", "vort_t", "residual"), "fno"),
])
def test_make_batch_pipeline_matches_jax(impl, dtype, fields, case):
    jg = jgrids.Grid((N, N), domain=DOMAIN)
    tg = tgrids.Grid((N, N), domain=DOMAIN)
    kw = dict(viscosity=1e-3, fft_impl=impl, mxu_precision="highest")
    nj = jeq.NavierStokes2DSpectral(grid=jg, dtype=jnp.dtype(dtype), **kw,
                                    **_flow(case, jg, jforcings, jeq))
    nt = teq.NavierStokes2DSpectral(
        grid=tg, dtype=torch.float64 if dtype == np.float64 else torch.float32,
        device="cpu", **kw, **_flow(case, tg, tforcings, teq))
    args = (DT, 3, 7, 2, 16)  # warmup, total steps, record every, stored size
    w0 = _spectrum(2, dtype)
    rj = jgen.make_batch_pipeline(nj, *args, fields=fields, max_steps_per_program=4)(
        jnp.asarray(w0))
    rt = tgen.make_batch_pipeline(nt, *args, fields=fields, max_steps_per_program=4)(
        torch.from_numpy(w0))
    assert rt.keys() == rj.keys() == set(fields)
    for k in fields:
        ref = np.asarray(rj[k])
        assert rt[k].shape == ref.shape == (2, 4, 16, 16)
        if dtype == np.float64:
            np.testing.assert_allclose(rt[k], ref, rtol=1e-9, atol=1e-9)
        else:
            np.testing.assert_allclose(rt[k], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _cli(tmp, num_samples, *extra):
    return ["--no-cuda", "--grid-size", str(N), "--subsample", "2",
            "--num-samples", str(num_samples), "--batch-size", "2",
            "--time", "0.008", "--time-warmup", "0.004", "--dt", str(DT),
            "--num-steps", "2", "--filepath", str(tmp), "--filename", "mc.npz",
            *extra]


def test_cli_writes_loadable_dataset_and_resumes(tmp_path):
    path = tgen.main_mcwilliams(_cli(tmp_path / "a", 3))
    data = jdatasets.load_trajectory_dict(path)
    w = data["vorticity"]
    assert w.dtype == np.float32 and w.shape[0] == 3 and w.shape[-2:] == (16, 16)
    assert np.isfinite(w).all()
    np.testing.assert_array_equal(data["random_states"], [0, 1, 2])
    assert data["stream"].shape == (3, 0)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["fft_impl"] == "dft_galerkin_fused" and meta["dt"] == DT

    mtime = os.path.getmtime(path)
    assert tgen.main_mcwilliams(_cli(tmp_path / "a", 3)) == path
    assert os.path.getmtime(path) == mtime  # complete: nothing regenerated

    tgen.main_mcwilliams(_cli(tmp_path / "a", 5))  # resume: samples 3 and 4
    resumed = jdatasets.load_trajectory_dict(path)
    np.testing.assert_array_equal(resumed["random_states"], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(resumed["vorticity"][:3], w)
    fresh = jdatasets.load_trajectory_dict(tgen.main_mcwilliams(_cli(tmp_path / "b", 5)))
    np.testing.assert_array_equal(resumed["vorticity"], fresh["vorticity"])


def test_integrator_without_the_kernel_takes_the_fastest_unfused_route(tmp_path):
    """Where the fused kernel cannot run the integrator (the fno dataset's
    IMEX order 2), the default is the fastest route without it in the H100
    table: torch.fft at every measured point, not the TPU's dft_galerkin."""
    for n, b in teq._H100_MS_PER_STEP:
        assert tgen.default_fft_impl(n, b, False, True, fused_ok=False) == "fft"
    assert tgen.default_fft_impl(256, 32, False, True, fused_ok=True) == "dft_galerkin_fused"
    assert tgen.default_fft_impl(256, 32, True, True, fused_ok=True) == "fft"
    # through the CLI's generation loop with an IMEX order-2 solver
    from tpu_cfd_torch.data import data_utils

    parser = data_utils.get_args_ns2d("IMEX order 2")
    parser.set_defaults(diam=2 * np.pi, forcing="none")
    args = parser.parse_args(_cli(tmp_path, 2))

    def make_ic(sample_ids, grid, dtype, device):
        gen = torch.Generator().manual_seed(0)
        return 1e2 * torch.randn((len(sample_ids), *grid.shape), dtype=dtype,
                                 generator=gen) / grid.shape[0]

    path = tgen.run_generation(args, make_ic, solver=teq.IMEXStepper(order=2),
                               example_name="IMEX2")
    with open(path + ".meta.json") as f:
        assert json.load(f)["fft_impl"] == "fft"
    assert np.isfinite(jdatasets.load_trajectory_dict(path)["vorticity"]).all()


def test_cli_double_runs_fp64_fft(tmp_path):
    path = tgen.main_mcwilliams(_cli(tmp_path, 2, "--double", "--extra-vars"))
    data = jdatasets.load_trajectory_dict(path)
    assert data["vorticity"].dtype == np.float64
    assert data["residual"].shape == data["vorticity"].shape
    with open(path + ".meta.json") as f:
        assert json.load(f)["fft_impl"] == "fft"


def test_cli_without_card_or_no_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in _cli(tmp_path, 2) if a != "--no-cuda"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main_mcwilliams(argv)


def test_unported_entry_points_raise(tmp_path, monkeypatch):
    """--data-parallel --no-cuda runs every dataset CLI in a world of one
    and stores the single-process dataset (tests/test_torch_parallel.py
    holds two ranks); an unknown dataset name exits with the usage line."""
    for main in (tgen.main_mcwilliams, tgen.main_kolmogorov, tgen.main_fno):
        p1 = main(_cli(tmp_path / main.__name__ / "single", 2))
        p2 = main(_cli(tmp_path / main.__name__ / "dp", 2, "--data-parallel"))
        assert not torch.distributed.is_initialized()
        with np.load(p1) as a, np.load(p2) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{main.__name__} {k}")
    monkeypatch.setattr(sys, "argv", ["generate", "nope"])
    with pytest.raises(SystemExit):
        tgen.main()


@pytest.mark.parametrize("name,extra", [
    ("kolmogorov", ()), ("fno", ()), ("fno", ("--replicable-init",)),
])
def test_new_clis_write_loadable_datasets_and_resume(tmp_path, name, extra):
    """Both CLIs end to end at 32² -> 16² on the CPU, with resume: the
    kolmogorov flow on RK4-CN (the fused Galerkin route's pin), the fno flow
    on IMEX order 2 (torch.fft)."""
    main = {"kolmogorov": tgen.main_kolmogorov, "fno": tgen.main_fno}[name]

    def argv(count, where):
        return [a if a != "mc.npz" else f"{name}.npz"
                for a in _cli(tmp_path / where, count, "--time", "0.01",
                              "--time-warmup", "0.004", *extra)]

    path = main(argv(3, "a"))
    data = jdatasets.load_trajectory_dict(path)
    w = data["vorticity"]
    assert w.dtype == np.float32 and w.shape == (3, 2, 16, 16)
    assert np.isfinite(w).all() and np.abs(w).max() > 0
    np.testing.assert_array_equal(data["random_states"], [0, 1, 2])
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["fft_impl"] == ("dft_galerkin_fused" if name == "kolmogorov" else "fft")
    main(argv(5, "a"))  # resume: samples 3 and 4
    resumed = jdatasets.load_trajectory_dict(path)
    np.testing.assert_array_equal(resumed["random_states"], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(resumed["vorticity"][:3], w)
    # a fresh run batches the samples differently ([2, 3], [4] against [2],
    # [3, 4]); torch's c2r FFT on the CPU rounds by batch size, which the
    # IC's pressure solve takes: the records agree to fp32 roundoff
    fresh = jdatasets.load_trajectory_dict(main(argv(5, "b")))
    np.testing.assert_allclose(resumed["vorticity"], fresh["vorticity"], rtol=0,
                               atol=1e-5 * np.abs(fresh["vorticity"]).max())


def test_kolmogorov_and_fno_initial_conditions(monkeypatch):
    """The kolmogorov IC is the curl of a filtered velocity of maximum speed
    --max-velocity (at the corners, as in JAX); the fno IC a GRF."""
    from tpu_cfd_torch.ops import finite_differences as tfdm
    from tpu_cfd_torch.solvers import initial_conditions as tic

    grid = tgrids.Grid((N, N), domain=DOMAIN)
    captured = {}

    def fake_run(args, make_ic, forcing_fn=None, solver=None, example_name=""):
        captured.update(args=args, ic=make_ic(np.arange(2), grid, torch.float64, "cpu"),
                        forcing=forcing_fn, solver=solver, name=example_name)

    monkeypatch.setattr(tgen, "run_generation", fake_run)
    tgen.main_kolmogorov(["--no-cuda", "--seed", "3", "--grid-size", str(N)])
    assert captured["name"] == "Kolmogorov2d" and captured["solver"] is None
    assert captured["args"].gamma == 0.1 and captured["args"].max_velocity == 5.0
    assert isinstance(captured["forcing"], tforcings.KolmogorovForcing)
    assert not captured["forcing"].vorticity
    noise = torch.stack([torch.randn((2, N, N), dtype=torch.float64,
                                     generator=tic.sample_generator(3, i))
                         for i in range(2)])
    v = tic.filtered_velocity_field(grid, 5.0, 4, dtype=torch.float64, noise=noise)
    assert torch.equal(captured["ic"], tfdm.curl_2d(v).data)

    tgen.main_fno(["--no-cuda", "--seed", "3", "--grid-size", str(N)])
    assert captured["name"] == "fnodata"
    assert isinstance(captured["solver"], teq.IMEXStepper) and captured["solver"].order == 2
    assert isinstance(captured["forcing"], tforcings.SinCosForcing)
    assert (captured["args"].time, captured["args"].time_warmup,
            captured["args"].diam) == (50.0, 30.0, 1.0)
    assert tuple(captured["ic"].shape) == (2, N, N) and captured["ic"].dtype == torch.float32
