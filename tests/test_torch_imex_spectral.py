"""The IMEX-2 step's kernels (``ops/cuda/imex_spectral.py``) and their route, on the CPU.

Imports only torch and the port. The route rule
(``NavierStokes2DSpectral._kernel_takes``: ``fft_impl="fft"``, a plain
contiguous tensor of the solver's device, complex dtype and half-spectrum
shape, no gradient; the matmul layouts, the fused rollout, a
``PencilEquation``, a gradient and the other refusals take the composed
path); the CPU route, which runs the wrappers' plain versions, against the
composed path bit for bit, for ``explicit_terms`` (forced and dealiased at
32² and 64², fp32 and fp64, leading dims of 1 and 2 as the recorder's
``residual`` passes them, every filter and forcing) and for IMEX-2 steps;
each plain version against the composed path's own expressions; the
wrappers' calls a step under every stepper and on the ``fno`` dataset CLI;
the wrappers' checks; an emulation of the mode kernels' walk over modes and
samples. The kernels themselves run on the card in
``tests/test_torch_cuda_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from tpu_cfd_torch import grids
from tpu_cfd_torch.ops.cuda import imex_spectral as im
from tpu_cfd_torch.ops.spectral import spectral_laplacian_2d, spectral_rot_2d
from tpu_cfd_torch.parallel import pencil
from tpu_cfd_torch.solvers import equations as eq, forcings

torch.set_num_threads(2)

DT = 1e-3
DTYPES = [torch.float32, torch.float64]
WRAPPERS = ("spectra", "advect", "finish", "rk2_cn_stage")


def _grid(n):
    return grids.Grid((n, n), domain=((0, 1.0), (0, 1.0)))


def _forcing(grid, kind):
    if kind == "sincos":  # the FNO dataset's, on the vorticity
        return forcings.SinCosForcing(grid=grid, scale=0.1, diam=1.0, wave_number=1,
                                      vorticity=True)
    if kind == "kolmogorov":  # a velocity forcing, curled into the spectrum
        return forcings.KolmogorovForcing(grid=grid, wave_number=2, diam=1.0)
    return None


def _solver(n=32, dtype=torch.float64, forcing="sincos", smooth=True, order=2, **kw):
    grid = _grid(n)
    kw.setdefault("solver", eq.IMEXStepper(order=order))
    return eq.NavierStokes2DSpectral(viscosity=1e-3, grid=grid, smooth=smooth,
                                     forcing_fn=_forcing(grid, forcing), dtype=dtype,
                                     device="cpu", **kw)


def _spectrum(lead, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.fft.rfft2(torch.randn((*lead, n, n), dtype=dtype, generator=gen))


def _bits(t):
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(_bits(got), _bits(want)), "equal values, other signs of zero"


def _composed(ns, mp):
    """``ns`` with the route rule turned off: the composed path."""
    mp.setattr(ns, "_kernel_takes", lambda u: False)
    return ns


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [32, 64])
def test_explicit_terms_route_equals_composed(n, dtype, lead):
    ns = _solver(n, dtype)
    w = _spectrum(lead, n, dtype)
    assert ns._kernel_takes(w)
    _same(ns.explicit_terms(w), ns._explicit_terms(w))


@pytest.mark.parametrize("forcing", [None, "sincos", "kolmogorov"])
@pytest.mark.parametrize("smooth", [False, True])
def test_explicit_terms_route_with_every_filter_and_forcing(smooth, forcing):
    ns = _solver(32, torch.float32, forcing=forcing, smooth=smooth)
    w = _spectrum((2,), 32, torch.float32, seed=1)
    assert ns._kernel_takes(w)
    _same(ns.explicit_terms(w), ns._explicit_terms(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [32, 64])
def test_imex2_steps_route_equal_composed(n, dtype):
    im.reset_launch_counts()
    w = _spectrum((3,), n, dtype, seed=2)
    got = _solver(n, dtype).forward(w, DT, steps=3)
    with pytest.MonkeyPatch.context() as mp:
        want = _composed(_solver(n, dtype), mp).forward(w, DT, steps=3)
    for g, x in zip(got, want):
        _same(g, x)
    assert not any(im.LAUNCHES.values())  # the CPU runs the plain versions


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_equal_the_composed_expressions(dtype):
    """Each wrapper's plain version against the composed path's own
    expressions (``_explicit_terms``, ``IMEXStepper._rk2_crank_nicolson``)."""
    ns = _solver(32, dtype)
    c = ns._kernel_constants()
    kx, ky = ns.kx, ns.ky
    w = _spectrum((2,), 32, dtype, seed=3)
    # spectra: the stack of _explicit_terms
    vhat = spectral_rot_2d(-w / spectral_laplacian_2d((kx, ky)), (kx, ky))
    specs = torch.stack([vhat[0], vhat[1], 2j * math.pi * kx * w, 2j * math.pi * ky * w])
    _same(im.spectra(w, c), specs)
    # advect: the product of the normalised inverse transforms
    vx, vy, gx, gy = torch.fft.irfft2(specs, s=ns.grid.shape).unbind(0)
    adv = -(gx * vx + gy * vy)
    _same(im.advect(torch.fft.irfft2(specs, s=ns.grid.shape, norm="forward"), c), adv)
    # finish: the 2/3 rule and the forcing
    terms = torch.fft.rfft2(adv)
    _same(im.finish(terms, c), terms * ns.filter + ns._forcing_term())
    # the two stages of the RK2 Crank-Nicolson update
    h, f = ns._explicit_terms(w), ns._explicit_terms(2 * w)
    alpha, beta = 0.5, 0.5
    g = w + beta * DT * ns.implicit_terms(w)
    _same(im.rk2_cn_stage(w, h, None, c, DT, alpha, beta),
          ns.implicit_solve(g + DT * h, beta * DT))
    _same(im.rk2_cn_stage(w, h, f, c, DT, alpha, beta),
          ns.implicit_solve(g + DT * (alpha * f + (1 - alpha) * h), beta * DT))


def _refused(case):
    """(solver, spectrum) that the route rule refuses, by case."""
    w = _spectrum((2,), 32, torch.float32)
    if case in ("dft", "dft_aligned", "dft_galerkin"):
        return _solver(32, torch.float32, fft_impl=case), w
    if case == "fused":
        return _solver(32, torch.float32, fft_impl="dft_galerkin", fused=True,
                       solver=None), w
    ns = _solver(32, torch.float32)
    if case == "pencil":  # the row slab's equation, without its process group
        eqn = pencil.PencilEquation.__new__(pencil.PencilEquation)
        eqn.__dict__.update(ns.__dict__)
        return eqn, w
    if case == "gradient":
        return ns, w.clone().requires_grad_(True)
    if case == "complex128":
        return ns, w.to(torch.complex128)
    if case == "real":
        return ns, torch.randn(2, 32, 17)
    if case == "not_contiguous":
        return ns, _spectrum((4,), 32, torch.float32)[::2]
    if case == "aligned_shape":
        return ns, w[..., :16].contiguous()
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dft", "dft_aligned", "dft_galerkin", "fused", "pencil",
                                  "gradient", "complex128", "real", "not_contiguous",
                                  "aligned_shape"])
def test_route_rule_refuses(case):
    ns, w = _refused(case)
    assert not ns._kernel_takes(w)


def test_route_rule_takes_cpu_and_no_grad():
    ns = _solver(32, torch.float32)
    w = _spectrum((2,), 32, torch.float32).requires_grad_(True)
    assert not ns._kernel_takes(w)
    with torch.no_grad():
        assert ns._kernel_takes(w)
    assert ns._kernel_takes(_spectrum((), 32, torch.float32))  # one sample, no batch dim
    assert _solver(32, torch.float64)._kernel_takes(_spectrum((1,), 32, torch.float64))


@pytest.mark.parametrize("fft_impl", ["dft", "dft_aligned", "dft_galerkin"])
def test_matmul_routes_call_no_wrapper(fft_impl, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a matmul route called an IMEX-spectral wrapper")

    for name in WRAPPERS:
        monkeypatch.setattr(im, name, refuse)
    ns = _solver(32, torch.float32, fft_impl=fft_impl)
    out = ns.forward(_spectrum((2,), 32, torch.float32), DT, steps=2)[0]
    assert torch.isfinite(torch.view_as_real(out)).all()


def _count_calls(monkeypatch):
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        fn = getattr(im, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(im, name, counted)
    return calls


@pytest.mark.parametrize("stepper,evaluations,stages", [
    (eq.IMEXStepper(order=1), 1, 0),
    (eq.IMEXStepper(order=1.5), 1, 0),
    (eq.IMEXStepper(order=2), 2, 2),
    (eq.RK4CrankNicolsonStepper(), 5, 0),
    (eq.RK4CrankNicolsonStepper(low_storage=False), 4, 0),
])
def test_wrapper_calls_a_step(stepper, evaluations, stages, monkeypatch):
    """Every stepper evaluates its explicit terms on the route; only the
    IMEX-2 update takes ``rk2_cn_stage``, the others keep their chains."""
    calls = _count_calls(monkeypatch)
    ns = _solver(32, torch.float32, solver=stepper)
    ns.forward(_spectrum((2,), 32, torch.float32), DT, steps=3)
    assert calls == {"spectra": 3 * evaluations, "advect": 3 * evaluations,
                     "finish": 3 * evaluations, "rk2_cn_stage": 3 * stages}


def test_fno_cli_takes_the_route(tmp_path, monkeypatch):
    """``generate fno`` with the extra variables: two evaluations and two
    stages a step, and one evaluation a recorded chunk for the residual, as
    ``chip_smoke.py``'s main path 12 counts the launches on the card."""
    from tpu_cfd_torch.data import generate

    calls = _count_calls(monkeypatch)
    generate.main_fno(["--grid-size", "32", "--subsample", "1", "--num-samples", "4",
                       "--batch-size", "2", "--time", "0.05", "--time-warmup", "0.02",
                       "--num-steps", "10", "--extra-vars", "--no-cuda",
                       "--filepath", str(tmp_path)])
    batches, steps = 2, 20 + 1 + 9 * 3  # warm-up, then records 3 steps apart
    assert calls == {"spectra": batches * (2 * steps + 1), "advect": batches * (2 * steps + 1),
                     "finish": batches * (2 * steps + 1), "rk2_cn_stage": batches * 2 * steps}


def test_residual_takes_the_route_on_two_leading_dims(monkeypatch):
    from tpu_cfd_torch.solvers import trajectories

    calls = _count_calls(monkeypatch)
    ns = _solver(32, torch.float32)
    rec = trajectories.get_trajectory_imex(ns, _spectrum((2,), 32, torch.float32), DT,
                                           num_steps=4, record_every_steps=2,
                                           fields=("vorticity", "residual"))
    assert rec["residual"].shape == (2, 2, 32, 17)
    assert calls["spectra"] == 2 * 3 + 1  # 3 steps, then one call on (t, b, n, m)


def test_checks_take_what_the_kernels_take():
    ns = _solver(32, torch.float32)
    c = ns._kernel_constants()
    w = _spectrum((3,), 32, torch.float32)
    assert im._check(c, "spectra", w) == 3
    assert im._check(c, "advect", torch.zeros(4, 3, 32, 32), spectral=False) == 12
    for bad in (w.to(torch.complex128), w[..., :16].contiguous(), _spectrum((6,), 32,
                torch.float32)[::2], w.clone().requires_grad_(True)):
        with pytest.raises(ValueError):
            im._check(c, "spectra", bad)
    with pytest.raises(ValueError):
        im._check(c, "rk2_cn_stage", w, w[:2])
    with pytest.raises(ValueError):
        im.spectra(torch.empty(3, 32, 17, dtype=torch.complex64, device="meta"), c)


def test_constants_refuse_foreign_tables():
    c = _solver(32, torch.float32)._kernel_constants()
    assert c.scale == 1.0 / 1024 and c.shape == (32, 32)
    args = dict(dx=c.dx, dy=c.dy, lap=c.lap, lin=c.lin, filt=c.filt, forcing=c.forcing,
                shape=c.shape)
    assert im.constants(**args) == c
    for key, bad in (("lin", c.lin.double()), ("dx", c.dx[:, :16]), ("filt", c.filt.t()),
                     ("forcing", c.filt)):
        with pytest.raises(ValueError):
            im.constants(**{**args, key: bad})
    with pytest.raises(ValueError):
        im.constants(**{**args, "lap": c.lap.half()})


@pytest.mark.parametrize("b", [1, 3, 32, 33, 257])
@pytest.mark.parametrize("n", [16, 256])
def test_mode_kernels_walk_each_mode_of_each_sample_once(n, b):
    """The mode kernels' grid (ceil(modes / THREADS), min(b, SLICES)): thread
    t of block (x, y) takes mode x THREADS + t of samples y, y + SLICES, ..."""
    modes = n * (n // 2 + 1)
    blocks_x, blocks_y = -(-modes // im.THREADS), min(b, im.SLICES)
    p = (np.arange(blocks_x)[:, None] * im.THREADS + np.arange(im.THREADS)).ravel()
    p = p[p < modes]
    seen = np.zeros((b, modes), dtype=np.int64)
    for y in range(blocks_y):
        seen[y::blocks_y, p] += 1
    assert (seen == 1).all()
