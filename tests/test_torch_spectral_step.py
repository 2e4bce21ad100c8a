"""The port's fused RK4-CN rollout (ops/cuda/spectral_step.py) vs the JAX kernel.

On the CPU the rollout runs its plain PyTorch version; it is held against
the JAX Pallas kernel in interpret mode (as tests/test_fused_step.py runs
it) and against the JAX unfused solver, on the same numpy inputs:
rel-L2 < 5e-6 against JAX "highest", < 1e-3 against JAX "high"
(the tolerances of tests/test_fused_step.py). The CUDA kernels themselves
run only on the card: the test marked ``cuda`` holds them against the plain
version there and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import grids as jgrids
from tpu_cfd.ops.pallas import spectral_step as jss
from tpu_cfd.solvers import equations as jeq, forcings as jforce
from tpu_cfd_torch import grids as tgrids
from tpu_cfd_torch.device import resolve_device
from tpu_cfd_torch.ops import dft2d as tdft
from tpu_cfd_torch.ops.cuda import spectral_step as tss
from tpu_cfd_torch.solvers import equations as teq, forcings as tforce

torch.set_num_threads(2)

N = 32
STEPS = 8
DT = 1e-3
DOMAIN = ((0, 2 * np.pi), (0, 2 * np.pi))
JG = jgrids.Grid((N, N), domain=DOMAIN)
TG = tgrids.Grid((N, N), domain=DOMAIN)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _spectrum(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, N, N))
    k = np.sqrt(np.fft.fftfreq(N)[:, None] ** 2 + np.fft.rfftfreq(N)[None] ** 2) * N
    return (np.fft.rfft2(x) * 20 * np.exp(-((k / 4) ** 2))).astype(np.complex64)


def _kw(forced, lib):
    if not forced:
        return dict(viscosity=1e-3)
    f = (jforce if lib == "jax" else tforce).KolmogorovForcing(
        grid=JG if lib == "jax" else TG, wave_number=2)
    return dict(viscosity=1e-2, drag=0.1, forcing_fn=f)


def _jax_solver(layout, forced, fused, precision="highest"):
    return jeq.NavierStokes2DSpectral(
        grid=JG, fft_impl=f"dft_{layout}", fused=fused, mxu_precision=precision,
        **_kw(forced, "jax"))


def _torch_solver(layout, forced, **kw):
    return teq.NavierStokes2DSpectral(
        grid=TG, fft_impl=f"dft_{layout}", fused=True, device="cpu",
        mxu_precision="highest", **_kw(forced, "torch"), **kw)


_JAX_CACHE = {}


def _jax_rollout(layout, forced, fused, precision="highest"):
    """JAX reference rollouts; the interpret-mode kernel is slow, so cache."""
    key = (layout, forced, fused, precision)
    if key not in _JAX_CACHE:
        ns = _jax_solver(layout, forced, fused, precision)
        _JAX_CACHE[key] = np.asarray(
            jax.jit(lambda w: ns.forward(w, DT, STEPS)[0])(jnp.asarray(_spectrum())))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("forced", [False, True])
class TestParity:
    def test_matches_jax_fused_kernel_highest(self, layout, forced):
        w, _ = _torch_solver(layout, forced).forward(torch.from_numpy(_spectrum()), DT, STEPS)
        assert _rel(w.numpy(), _jax_rollout(layout, forced, True)) < 5e-6

    def test_matches_jax_unfused_solver(self, layout, forced):
        w, _ = _torch_solver(layout, forced).forward(torch.from_numpy(_spectrum()), DT, STEPS)
        assert _rel(w.numpy(), _jax_rollout(layout, forced, False)) < 5e-6

    def test_matches_port_unfused_solver(self, layout, forced):
        w0 = torch.from_numpy(_spectrum(1))
        fused, _ = _torch_solver(layout, forced).forward(w0, DT, STEPS)
        ref = teq.NavierStokes2DSpectral(
            grid=TG, fft_impl=f"dft_{layout}", device="cpu",
            mxu_precision="highest", **_kw(forced, "torch"))
        plain, _ = ref.forward(w0, DT, STEPS)
        assert _rel(fused.numpy(), plain.numpy()) < 5e-6


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_within_jax_high_tolerance(layout):
    w, _ = _torch_solver(layout, False).forward(torch.from_numpy(_spectrum()), DT, STEPS)
    assert _rel(w.numpy(), _jax_rollout(layout, False, True, "high")) < 1e-3


def test_aligned_public_layout_has_zero_nyquist_column():
    w, _ = _torch_solver("aligned", False).forward(torch.from_numpy(_spectrum()), DT, 2)
    assert tuple(w.shape) == (2, N, N // 2 + 1)
    assert bool((w[..., -1] == 0).all())


def test_unbatched_equals_batched_row():
    ns = _torch_solver("galerkin", False)
    w0 = torch.from_numpy(_spectrum())
    wb, _ = ns.forward(w0, DT, STEPS)
    w1, _ = ns.forward(w0[0], DT, STEPS)
    assert _rel(w1.numpy(), wb[0].numpy()) < 1e-6


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_host_constants_equal_jax(layout):
    """Per-mode constants (convert's contract: bit for bit)."""
    args = (N, tuple(float(s) for s in TG.step), 1e-2, 0.1, DT)
    if layout == "galerkin":
        ours, ref = tss._host_constants_galerkin(*args), jss._host_constants_galerkin(*args)
    else:
        ours, ref = tss._host_constants(*args), jss._host_constants(*args)
    assert ours.keys() == ref.keys()
    assert ours["mus"] == ref["mus"]
    for k in ("tkx", "tky", "ilap", "filt", "lin", "dens"):
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_block_cols_validation():
    w = _torch_solver("galerkin", False)._align(torch.from_numpy(_spectrum()))
    kw = dict(grid=TG, viscosity=1e-3, drag=0.0, dt=DT, steps=2, precision="highest")
    ref = tss.fused_rollout_galerkin(w, block_cols=None, **kw)
    for bc in ("auto", 8, 16):
        out = tss.fused_rollout_galerkin(w, block_cols=bc, **kw)
        assert _rel(out.numpy(), ref.numpy()) < 1e-6
    with pytest.raises(ValueError, match="divide"):
        tss.fused_rollout_galerkin(w, block_cols=12, **kw)
    assert tss.resolve_block_cols("auto", 256, 86) == 64
    assert tss.resolve_block_cols(None, 256, 86) == 256
    with pytest.raises(ValueError, match="shared memory"):
        tss.resolve_block_cols(None, 4096, 2048)


def test_input_validation():
    w = torch.from_numpy(_spectrum())
    kw = dict(grid=TG, viscosity=1e-3, drag=0.0, dt=DT, steps=1)
    with pytest.raises(ValueError, match="fp32-only"):
        tss.fused_rollout_aligned(w[..., :16].to(torch.complex128), **kw)
    with pytest.raises(ValueError, match="precision"):
        tss.fused_rollout_aligned(w[..., :16], precision="tf32", **kw)
    with pytest.raises(ValueError, match="expected aligned spectrum"):
        tss.fused_rollout_aligned(w, **kw)


def test_cpu_path_runs_plain_version_and_counts_no_launch():
    tss.reset_launch_counts()
    _torch_solver("galerkin", False).forward(torch.from_numpy(_spectrum()), DT, 1)
    assert all(v == 0 for v in tss.LAUNCHES.values())


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here, without a
    card or nvcc, every kernel path raises."""
    c = tss.constants("galerkin", TG, 1e-3, 0.0, DT, "cpu")
    w = torch.zeros((1, c["R"], c["m"]), dtype=torch.complex64)
    with pytest.raises(ValueError, match="no spectral-step kernel"):
        tss.inverse_first(w.to("meta"), c)
    with pytest.raises(ValueError, match="no fused rollout"):
        tss.fused_rollout_galerkin(w.to("meta"), grid=TG, viscosity=1e-3,
                                   drag=0.0, dt=DT, steps=1)
    if not torch.cuda.is_available():
        # the kernel path needs nvcc and a card, and says so
        with pytest.raises(RuntimeError):
            tss._launch_inverse_first(w, c)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_gradient_raises():
    w = _torch_solver("galerkin", False)._align(torch.from_numpy(_spectrum()))
    w = w.clone().requires_grad_(True)
    out = tss.fused_rollout_galerkin(w, grid=TG, viscosity=1e-3, drag=0.0,
                                     dt=DT, steps=1)
    with pytest.raises(RuntimeError, match="forward-only"):
        out.abs().sum().backward()


def test_flops_per_sample_step_matches_jax_formula():
    rows, m = tdft.galerkin_block(256)
    assert tss.flops_per_sample_step("galerkin", 256) == 5 * (
        40 * 256 * len(rows) * m + 20 * 256 * 256 * m)
    assert tss.flops_per_sample_step("galerkin", 256) == 1_312_153_600


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_kernels_match_plain_on_the_card(layout):
    """On the card: the CUDA rollout vs its plain version, rel-L2 < 5e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m cuda tests/test_torch_spectral_step.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ns = teq.NavierStokes2DSpectral(viscosity=1e-3, grid=TG, fft_impl=f"dft_{layout}",
                                    fused=True, device=dev)
    w = ns._align(torch.from_numpy(_spectrum()).to(dev)).contiguous()
    c = tss.constants(layout, TG, 1e-3, 0.0, DT, dev)
    tss.reset_launch_counts()
    got = tss._fused_rollout(w, layout=layout, grid=TG, viscosity=1e-3, drag=0.0,
                             dt=DT, steps=STEPS, forcing_hat=None,
                             precision="highest", block_cols="auto")
    assert tss.LAUNCHES == {k: STEPS * 5 for k in tss.LAUNCHES}
    want = tss._fused_rollout_plain(w, c, STEPS)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(), want.cpu().numpy()) < 5e-6


def test_advect_layout_by_shape():
    """K2's shared-memory rule: 32 rows a block at 256^2 in both layouts
    (3 and 4 passes over T's 2m columns; two blocks an SM fit at Galerkin),
    8 at 1024^2, each within one block's 227 KB; a spectrum too wide for 8
    rows is refused with a message."""
    rows, m = tdft.galerkin_block(256)
    assert tss.advect_layout(256, m, 64) == (32, 3, 114_192)
    assert 2 * (114_192 + 1024) <= 233_472        # two blocks an SM, 1 KB each reserved
    assert tss.advect_layout(256, 128, 64) == (32, 4, 156_432)
    assert tss.advect_layout(256, m, 256)[0] == 32    # block_cols=None: whole rows
    m1024 = tdft.galerkin_block(1024)[1]
    for mm in (m1024, 512):                           # 1024^2: Galerkin, aligned
        tx, passes, nbytes = tss.advect_layout(1024, mm, 64)
        assert tx == 8 and passes <= 12 and nbytes <= tss._MAX_SMEM
        assert tss.resolve_block_cols("auto", 1024, mm) == 64
    for n, mm in ((256, m), (256, 128), (512, 171), (1024, m1024), (32, 11)):
        tx, passes, nbytes = tss.advect_layout(n, mm, 64)
        cols = 4 * (256 // min(tx, 16))
        assert passes * cols >= 2 * mm > (passes - 1) * cols
        fr = max(f for f in (1, 2, 4, 8, 16) if f == 1 or f * passes * cols <= 1024)
        k1p = -(-2 * mm // 16) * 16
        slot = max(1024, fr * passes * cols)
        assert nbytes == 4 * (k1p * (4 * tx + 4) + 3 * slot + (64 + fr) * (tx + 1))
    assert tss.advect_layout(2048, 1024, 64) is None
    with pytest.raises(ValueError, match="shared memory"):
        tss.resolve_block_cols("auto", 2048, 1024)


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_kernel_operand_layouts(layout):
    """The kernels' copies of the constants: G and F transposed, the four
    multipliers of a mode side by side, IL's rows re/im interleaved."""
    c = tss.constants(layout, TG, 1e-3, 0.0, DT, "cpu")
    assert torch.equal(c["GT"], c["G"].T) and torch.equal(c["FT"], c["F"].T)
    assert torch.equal(c["cf4"], c["cf"].permute(1, 2, 0))
    assert torch.equal(c["il"][0::2], c["il_re"]) and torch.equal(c["il"][1::2], c["il_im"])
    assert all(c[k].is_contiguous() for k in ("GT", "FT", "cf4", "il"))
