"""The port's fused RK4-CN rollout (ops/cuda/spectral_step.py) vs the JAX kernel.

On the CPU the rollout runs its plain PyTorch version; it is held against
the JAX Pallas kernel in interpret mode (as tests/test_fused_step.py runs
it) and against the JAX unfused solver, on the same numpy inputs:
rel-L2 < 5e-6 against JAX "highest", < 1e-3 against JAX "high"
(the tolerances of tests/test_fused_step.py). The CUDA kernels themselves
run only on the card: the test marked ``cuda`` holds them against the plain
version there and skips here. What the card's kernels compute by FFTs is
held here instead: the first-axis kernels' (K1, K3) slot map and transforms
(with ``torch.fft``) and their shared-memory indexing against the plain
version, the advection kernel's (K2) packing of rows into complex transforms
(with ``torch.fft``) against the plain version, its Stockham passes and
twiddle table against ``numpy.fft``, and the kernels' block layout rules.
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
    # the card's K2 takes whole rows whatever block_cols, and refuses only
    # an n it does not take; the CPU path validates block_cols for any n
    assert tss.resolve_block_cols(None, 4096, 2048) == 4096
    assert tss.resolve_block_cols("auto", 96, 32) == 32
    for n in (96, 4096):
        with pytest.raises(ValueError, match="power of two"):
            tss.advect_layout(n)


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


def _k2_fill(rows, tx, threads, nbytes):
    """The share of an H100's block slots that ``rows`` rows in K2 blocks of
    ``tx`` rows keep busy: 132 SMs, 16 warps an SM under K2's launch bounds
    (128 registers a thread), 233,472 bytes of shared memory an SM less 1 KB
    a block; one wave spread over the SMs, or whole waves."""
    per_sm = min(233_472 // (nbytes + 1024), 16 * 32 // threads, 32)
    blocks = -(-rows // tx)
    live = rows / (blocks * tx)
    if blocks <= 132 * per_sm:
        return live * blocks / (132 * -(-blocks // 132))
    return live * blocks / (132 * per_sm * -(-blocks // (132 * per_sm)))


def test_advect_layout_by_shape():
    """K2's block rule: n/16 threads a row, the fewest rows a block that pair
    up and make a whole warp, two padded rows of n points a physical row in
    shared memory, within one block's 232,448 bytes; at 256², b=32 the
    blocks fill the 132 SMs in whole waves (two of 2,112, the second 94 %
    full: no power of two fills 132 exactly), and no larger block fills them
    better at any batch; n must be a power of two from 16 to 2048."""
    assert tss.advect_layout(256) == (2, 32, 8_704)
    assert _k2_fill(32 * 256, 2, 32, 8_704) == 4096 / (2 * 2112) > 0.96
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048):
        g = n // 16
        stride = tss._k2_row_floats(n)
        assert stride >= 2 * (n + n // 16)
        if g < 16:  # rows sharing a half-warp start on distinct banks
            assert stride % 16 == g
        tx, threads, nbytes = tss.advect_layout(n)
        assert tx % 2 == 0 and threads == tx * g == max(32, 2 * g)
        assert nbytes == tx * stride * 8 <= 232_448
        for b in (1, 3, 8, 32, 128):
            best = _k2_fill(b * n, tx, threads, nbytes)
            for big in (2 * tx, 4 * tx, 8 * tx):
                if big * g <= 256:
                    assert _k2_fill(b * n, big, big * g, big * stride * 8) <= best
    assert tss.advect_layout(1024)[:2] == (2, 128)
    for n in (8, 96, 100, 4096):
        assert not tss.advect_takes(n)
        with pytest.raises(ValueError, match="power of two from 16 to 2048"):
            tss.advect_layout(n)


def _hermitian(a, d, n):
    """The spectrum of the complex row a + i d from the kept bins of two real
    rows: Z[c] = a_c + i d_c, Z[n - c] = conj(a_c) + i conj(d_c), bin 0
    Re a_0 + i Re d_0 (its imaginary parts dropped), zero elsewhere."""
    m = a.shape[-1]
    z = torch.zeros(a.shape[:-1] + (n,), dtype=a.dtype)
    z[..., 1:m] = a[..., 1:m] + 1j * d[..., 1:m]
    z[..., n - m + 1:] = torch.flip(a[..., 1:m].conj() + 1j * d[..., 1:m].conj(), [-1])
    z[..., 0] = a[..., 0].real + 1j * d[..., 0].real
    return z


def _advect_packed(A, n, by_size=True, dtype=torch.complex128):
    """K2's function by the card kernel's scheme, with torch.fft in
    ``dtype``: two complex inverse transforms a row, z1 = u + i v and
    z2 = ∂ω/∂x + i ∂ω/∂y (``by_size``; else u + i ∂ω/∂x and v + i ∂ω/∂y), the
    product -(u ∂ω/∂x + v ∂ω/∂y) read from their real and imaginary parts,
    and rows x, x + 1 in one forward transform Y of adv_x + i adv_{x+1},
    split as T_x = (Y[c] + conj Y[n - c]) / 2 and
    T_{x+1} = (Y[c] - conj Y[n - c]) / 2i."""
    u, v, gx, gy = A.to(dtype).unbind(1)
    if by_size:
        z1 = torch.fft.ifft(_hermitian(u, v, n), dim=-1)
        z2 = torch.fft.ifft(_hermitian(gx, gy, n), dim=-1)
        adv = -(z1.real * z2.real + z1.imag * z2.imag)
    else:
        z1 = torch.fft.ifft(_hermitian(u, gx, n), dim=-1)
        z2 = torch.fft.ifft(_hermitian(v, gy, n), dim=-1)
        adv = -(z1.real * z1.imag + z2.real * z2.imag)
    Y = torch.fft.fft(adv[:, 0::2] + 1j * adv[:, 1::2], dim=-1)
    m = A.shape[-1]
    yc = Y[..., :m]
    ym = torch.roll(torch.flip(Y, [-1]), 1, -1)[..., :m].conj()  # conj Y[(n - c) % n]
    T = torch.empty(A.shape[0], n, m, dtype=dtype)
    T[:, 0::2], T[:, 1::2] = (yc + ym) / 2, (yc - ym) / 2j
    return T.to(torch.complex64)


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n", [16, 32, 64, 256])
def test_packed_fft_scheme_matches_plain(layout, n):
    """The card kernel's packing of rows into complex FFTs computes the plain
    version's function, bin 0's imaginary part ignored as ``inv_last_im``'s
    zero row ignores it (rel-L2 < 1e-5, batch 3)."""
    grid = tgrids.Grid((n, n), domain=DOMAIN)
    c = tss.constants(layout, grid, 1e-3, 0.0, DT, "cpu")
    gen = torch.Generator().manual_seed(n)
    A = torch.randn(3, 4, n, c["m"], dtype=torch.complex64, generator=gen)
    assert bool((A[..., 0].imag.abs() > 0).all())
    want = tss._advect_plain(A, c)
    assert _rel(_advect_packed(A, n).numpy(), want.numpy()) < 1e-5
    # bin 0's imaginary part changes neither
    B = A.clone()
    B[..., 0] = B[..., 0].real.to(torch.complex64)
    assert _rel(_advect_packed(B, n).numpy(), want.numpy()) < 1e-5
    assert _rel(tss._advect_plain(B, c).numpy(), want.numpy()) < 1e-6
    # the other pairing computes the same function
    assert _rel(_advect_packed(A, n, by_size=False).numpy(), want.numpy()) < 1e-5


def _k1_slots(n, R):
    """The card's K1 puts kept row r at slot r below R/2 and at n - R + r
    from R/2 up."""
    return np.array([r if r < R // 2 else n - R + r for r in range(R)])


def _inverse_first_fft(w, c, n):
    """K1's function by the card kernel's scheme, with torch.fft: each
    field's R rows scattered to their slots of an n-point column (zeros
    elsewhere), times i c_f, and the inverse transform along the first axis
    (1/n normalised, as G is)."""
    z = torch.zeros(w.shape[0], 4, n, c["m"], dtype=torch.complex64)
    z[:, :, torch.from_numpy(_k1_slots(n, c["R"]))] = w.unsqueeze(1) * (1j * c["cf"])
    return torch.fft.ifft(z, dim=-2)


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n", [16, 32, 64, 256])
def test_inverse_fft_scheme_matches_plain(layout, n):
    """The card's first-axis FFTs compute the dense product G (i c_f w) of
    the plain version (rel-L2 < 1e-5, batch 3): the slots are the Galerkin
    block's signed rows, with the zero gap between kmax and n - kmax, and
    the identity on the aligned layout."""
    grid = tgrids.Grid((n, n), domain=DOMAIN)
    c = tss.constants(layout, grid, 1e-3, 0.0, DT, "cpu")
    R = c["R"]
    slots = _k1_slots(n, R)
    if layout == "galerkin":
        rows, _ = tdft.galerkin_block(n)
        kmax = R // 2
        assert np.array_equal(slots, rows) and R < n
        assert set(range(kmax, n - kmax)).isdisjoint(slots)
    else:
        assert np.array_equal(slots, np.arange(n))
    w = torch.randn(3, R, c["m"], dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(n))
    want = tss._inverse_first_plain(w, c)
    assert _rel(_inverse_first_fft(w, c, n).numpy(), want.numpy()) < 1e-5


def _k1_strides(n, R, tc):
    """K1's shared-memory strides as the kernel computes them: staged rows
    ``tc | 1`` apart, multiplier planes ``cfs`` floats apart and output
    planes ``fs`` float2 apart (``k1_cf_stride``, ``k1_out_stride``)."""
    g, tcp = n // 16, tc | 1
    return tcp, R * tcp + (g * tcp - R * tcp) % 32, n * tcp + g * tcp % 16


def _k1_phase_bytes(n, R, tc, fb):
    """Bytes of each phase a K1 block keeps in shared memory, as the kernel
    sizes them (``k1_smem`` takes the largest): (1) w's tile and fb planes
    of multipliers, (2) tc fb exchange rows of n points, one float2 of
    padding every 16, (3) fb planes of outputs."""
    tcp, cfs, fs = _k1_strides(n, R, tc)
    return 8 * R * tcp + 4 * fb * cfs, 8 * tc * fb * (n + n // 16), 8 * fb * fs


def _k1_blocks(w, cf, n, tc, fb):
    """The card's K1 as its blocks index shared memory: thread tid stages
    column tid % tc of rows tid / tc + j fb G of w and of fb multiplier
    planes (rows tc | 1 apart, planes ``cfs`` apart), transform (col, fl)
    reads its points p = t + G k from there, the outputs go point-major
    (planes ``fs`` apart) and come back as rows of A. Each phase's arrays
    hold exactly the bytes ``_k1_phase_bytes`` gives, so every index stays
    inside them, and every entry of A is written once."""
    b, R, m = w.shape
    g, rstep = n // 16, fb * n // 16
    tcp, cfs, fs = _k1_strides(n, R, tc)
    staged, _, outs = _k1_phase_bytes(n, R, tc, fb)
    tid = np.arange(tc * fb * g)
    t, i = tid % g, tid // g
    col, fl = i // fb, i % fb
    cc, r0 = tid % tc, tid // tc
    A = np.zeros((b, 4, n, m), complex)
    hits = np.zeros((b, 4, n, m), int)
    for s in range(b):
        for f0 in range(0, 4, fb):
            for c0 in range(0, m, tc):
                ws = np.zeros(R * tcp, complex)
                cs = np.zeros(fb * cfs)
                assert 8 * ws.size + 4 * cs.size == staged
                live = cc < m - c0
                for r in range(R):
                    th = (r0 % rstep == r % rstep) & (r0 <= r)  # threads staging row r
                    assert th.sum() == tc
                    o = r * tcp + cc[th]
                    cols = np.minimum(c0 + cc[th], m - 1)
                    ws[o] = np.where(live[th], w[s, r, cols], 0)
                    for q in range(fb):
                        cs[q * cfs + o] = np.where(live[th], cf[f0 + q, r, cols], 0)
                p = t[:, None] + g * np.arange(16)[None]
                kept = (p < R // 2) | (p >= n - R // 2)
                r = np.where(p < R // 2, p, p - (n - R))
                z = np.where(kept, ws[col[:, None] + r * tcp]
                             * 1j * cs[fl[:, None] * cfs + col[:, None] + r * tcp], 0) / n
                cols_ = np.zeros((tc * fb, n), complex)
                cols_[i[:, None], p] = z
                out = n * np.fft.ifft(cols_, axis=-1)
                os_ = np.zeros(fb * fs, complex)
                assert 8 * os_.size == outs
                x = t[:, None] + g * np.arange(16)[None]
                os_[fl[:, None] * fs + x * tcp + col[:, None]] = out[i[:, None], x]
                row = r0[:, None] + rstep * np.arange(16)[None]
                q, xx = row // n, row % n
                ok = np.broadcast_to(live[:, None], row.shape)
                cols = np.broadcast_to((c0 + cc)[:, None], row.shape)
                A[s, f0 + q[ok], xx[ok], cols[ok]] = os_[(q * fs + xx * tcp + cc[:, None])[ok]]
                hits[s, f0 + q[ok], xx[ok], cols[ok]] += 1
    assert (hits == 1).all()
    return A


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n,tc,fb", [(16, 8, 4), (64, 8, 4), (64, 3, 1), (64, 5, 4),
                                     (256, 8, 1)])
def test_inverse_kernel_indexing(layout, n, tc, fb):
    """K1's staging, slot map and point-major outputs, as the card kernel
    indexes them (``_k1_blocks``), give the plain version's A (rel-L2
    < 1e-5, batch 2), with tiles that overrun m and odd column counts."""
    c = tss.constants(layout, tgrids.Grid((n, n), domain=DOMAIN), 1e-3, 0.0, DT, "cpu")
    w = torch.randn(2, c["R"], c["m"], dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(n + tc))
    got = _k1_blocks(w.numpy(), c["cf"].numpy(), n, tc, fb)
    assert _rel(got, tss._inverse_first_plain(w, c).numpy()) < 1e-5


def test_inverse_layout_by_shape():
    """K1's block rule: 8 columns a block (4 from 1024²), all four fields up
    to 128² and one from 256², n/16 threads a column's transform; a whole
    number of warps up to 512 threads (the kernel's launch bound), within a
    block's 232,448 bytes of shared memory at every n it takes, in both
    layouts; an n it does not take raises."""
    assert tss.inverse_layout(256, 170) == (8, 1, 128)
    assert max(_k1_phase_bytes(256, 170, 8, 1)) == 18_448
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048):
        for R in (len(tdft.galerkin_block(n)[0]), n):
            tc, fb, threads = tss.inverse_layout(n, R)
            assert (tc, fb) == ((8 if n <= 512 else 4), (4 if n <= 128 else 1))
            assert threads == tc * fb * n // 16 and threads % 32 == 0 and threads <= 512
            assert max(_k1_phase_bytes(n, R, tc, fb)) <= 232_448
    for n in (8, 96, 4096):
        with pytest.raises(ValueError, match="power of two from 16 to 2048"):
            tss.inverse_layout(n, n)


def _forward_first_fft(T, c, n):
    """K3's transform by the card kernel's scheme, with torch.fft: each
    column's unnormalised n-point forward transform along the first axis,
    as F is, read at K1's slots."""
    return torch.fft.fft(T, dim=-2)[:, torch.from_numpy(_k1_slots(n, c["R"]))]


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n", [16, 32, 64, 256])
def test_forward_fft_scheme_matches_plain(layout, n):
    """The card's first-axis forward FFTs, read at K1's slots, compute the
    dense product F T of the plain version (rel-L2 < 1e-5, batch 3)."""
    c = tss.constants(layout, tgrids.Grid((n, n), domain=DOMAIN), 1e-3, 0.0, DT, "cpu")
    T = torch.randn(3, n, c["m"], dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(n + 1))
    want = torch.matmul(c["F"], T)
    assert _rel(_forward_first_fft(T, c, n).numpy(), want.numpy()) < 1e-5


def _k3_phase_bytes(n, R, tc):
    """Bytes of each phase a K3 block keeps in shared memory, as the kernel
    sizes them (``k3_smem`` takes the largest): h's and w's tiles (R rows
    ``tc | 1`` apart each) beside (1) T's tile of n rows, (2) tc exchange
    rows of n points, one float2 of padding every 16, (3) the R kept rows."""
    tcp = tc | 1
    hw = 8 * 2 * R * tcp
    return 8 * n * tcp + hw, 8 * tc * (n + n // 16) + hw, 8 * R * tcp + hw


def _k3_blocks(T, w, h, c, n, tc, k):
    """The card's K3 as its blocks index shared memory: thread tid stages
    column cc = tid % tc of rows tid / tc + j G of T (rows tc | 1 apart, zeros
    past column m) and of h (past stage 0) and w after the region that T's
    tile, the exchange rows and the kept outputs share; transform col reads
    its points t + G k from there, its kept outputs go point-major to row
    ``kept_row`` of their slot, and thread tid updates column cc of rows
    tid / tc + j G. Unwritten shared memory reads NaN, so a read of it shows
    in the result; every entry of h and w is written once."""
    b, _, m = T.shape
    R = c["R"]
    g, tcp = n // 16, tc | 1
    region = max(n * tcp, tc * (n + g))
    hs, ws = region, region + R * tcp
    tid = np.arange(tc * g)
    t, col = tid % g, tid // g
    cc, r0 = tid % tc, tid // tc
    j = np.arange(16)[None]
    filt, frc, lin = c["filt"].numpy(), c["forcing"].numpy(), c["lin"].numpy()
    dens, beta = c["dens"][k].numpy(), tss._BETAS[k]
    dtg, mu = c["dt_gammas"][k], c["mus"][k]
    W, H = w.astype(complex), h.astype(complex)
    hits = np.zeros(w.shape, int)
    for s in range(b):
        for c0 in range(0, m, tc):
            sm = np.full(region + 2 * R * tcp, np.nan, complex)
            assert 8 * sm.size == max(_k3_phase_bytes(n, R, tc))
            live = cc < m - c0
            cols = np.broadcast_to(np.minimum(c0 + cc, m - 1)[:, None], (tc * g, 16))
            x = r0[:, None] + g * j
            sm[x * tcp + cc[:, None]] = np.where(live[:, None], T[s, x, cols], 0)
            rr = r0[:, None] + g * j
            ok = live[:, None] & (rr < R)
            o = (rr * tcp + cc[:, None])[ok]
            if k:
                sm[hs + o] = h[s, rr[ok], cols[ok]]
            sm[ws + o] = w[s, rr[ok], cols[ok]]
            p = t[:, None] + g * j
            tiles = np.zeros((tc, n), complex)
            tiles[col[:, None], p] = sm[p * tcp + col[:, None]]
            out = np.fft.fft(tiles, axis=-1)
            sm[:region] = np.nan  # the exchange rows' contents
            r = np.where(p < R // 2, p, np.where(p >= n - R // 2, p - (n - R), -1))
            kept = r >= 0
            sm[(r * tcp + col[:, None])[kept]] = out[col[:, None], p][kept]
            rk, ck = rr[ok], cols[ok]
            e = sm[o] * filt[rk, ck] + frc[rk, ck]
            hv = e + beta * sm[hs + o] if k else e
            wv = sm[ws + o]
            W[s, rk, ck] = (wv + dtg * hv + mu * (lin[rk, ck] * wv)) * dens[rk, ck]
            H[s, rk, ck] = hv
            hits[s, rk, ck] += 1
    assert (hits == 1).all() and np.isfinite(W).all() and np.isfinite(H).all()
    return W, H


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
@pytest.mark.parametrize("n,tc,k", [(16, 32, 0), (64, 6, 3), (64, 3, 1), (128, 5, 0),
                                    (256, 12, 2)])
def test_forward_kernel_indexing(layout, n, tc, k):
    """K3's staging, point-major kept outputs and (r, c) update walk, as the
    card kernel indexes them (``_k3_blocks``), give the plain version's
    (w, h) at stage 0 and later stages (rel-L2 < 1e-5, batch 2), with tiles
    that overrun m and odd column counts."""
    grid = tgrids.Grid((n, n), domain=DOMAIN)
    gen = torch.Generator().manual_seed(n + tc + k)
    c = tss.constants(layout, grid, 1e-3, 0.1, DT, "cpu")
    R, m = c["R"], c["m"]
    c["forcing"] = torch.randn(R, m, dtype=torch.complex64, generator=gen)
    T = torch.randn(2, n, m, dtype=torch.complex64, generator=gen)
    w = torch.randn(2, R, m, dtype=torch.complex64, generator=gen)
    h = torch.randn(2, R, m, dtype=torch.complex64, generator=gen)
    assert m % tc
    got = _k3_blocks(T.numpy(), w.numpy(), h.numpy(), c, n, tc, k)
    want = tss._forward_first_plain(T, w, h, c, k)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_.numpy()) < 1e-5


def test_forward_layout_by_shape():
    """K3's block rule: 16 columns a block up to 256² (32 at 16²), 8 at 512²
    and 1024², 3 at 2048², n/16 threads a column's transform; a whole number
    of warps up to 512 threads (the kernel's launch bound), each phase's
    shared memory within a block's 232,448 bytes at every n it takes, in both
    layouts; an n it does not take raises."""
    assert tss.forward_layout(256, 170) == (16, 256)
    assert max(_k3_phase_bytes(256, 170, 16)) == 81_056
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048):
        for R in (len(tdft.galerkin_block(n)[0]), n):
            tc, threads = tss.forward_layout(n, R)
            assert tc == {16: 32, 512: 8, 1024: 8, 2048: 3}.get(n, 16)
            assert threads == tc * n // 16 and threads % 32 == 0 and threads <= 512
            assert max(_k3_phase_bytes(n, R, tc)) <= 232_448
    for n in (8, 96, 4096):
        with pytest.raises(ValueError, match="power of two from 16 to 2048"):
            tss.forward_layout(n, n)


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_packing_pairs_fields_of_like_size(layout):
    """Why the kernel packs u with v and ∂ω/∂x with ∂ω/∂y: in fp32 a complex
    row's rounding follows its larger part, and at 256² the gradient exceeds
    the velocity by up to ~85² at the top modes, so u + i ∂ω/∂x loses u's
    digits. On K1's output of a random spectrum, paired by size the fp32
    transforms stay within 2e-6 of the plain version's largest entry, the
    other way they miss by more than 2e-5."""
    n = 256
    c = tss.constants(layout, tgrids.Grid((n, n), domain=DOMAIN), 1e-3, 0.1, DT, "cpu")
    w = torch.randn(2, c["R"], c["m"], dtype=torch.complex64,
                    generator=torch.Generator().manual_seed(9))
    A = tss._inverse_first_plain(w, c)
    want = tss._advect_plain(A, c)

    def err(by_size):
        got = _advect_packed(A, n, by_size, torch.complex64)
        return float((got - want).abs().max() / want.abs().max())

    assert err(True) < 2e-6 < 2e-5 < err(False)


def _stockham(x, inverse):
    """The card kernel's passes over rows x (rows, n), as its threads index
    them: thread t holds points t + (n/16) k; butterfly j = t + (n/16) q of
    pass p (radix R, NS = 16^p) takes points j + r n/R, twiddles input r by
    table entry [r - 1][j % NS] (conjugated for the inverse), and a pass
    before the last sends output r to (j / NS) NS R + j % NS + r NS."""
    n = x.shape[-1]
    g = n // 16
    tw = tss._twiddles(n).astype(np.complex128)
    radices = tss._fft_passes(n)
    t, k = np.arange(g)[:, None], np.arange(16)[None, :]
    v = x[..., t + g * k]
    off = 0
    for p, R in enumerate(radices):
        bf, ns = 16 // R, 16 ** p
        r = np.arange(R)
        dft = np.exp((1 if inverse else -1) * 2j * np.pi * np.outer(r, r) / R)
        new = np.empty_like(v)
        for q in range(bf):
            j = np.arange(g) + g * q
            idx = q + bf * r
            u = v[..., idx]
            if ns > 1:
                w = np.stack([np.ones(g)] + [tw[off + (i - 1) * ns + (j & (ns - 1))]
                                             for i in range(1, R)], -1)
                u = u * (w.conj() if inverse else w)
            new[..., idx] = u @ dft
        v = new
        if ns > 1:
            off += (R - 1) * ns
        if p < len(radices) - 1:
            buf = np.empty(x.shape, complex)
            buf[..., (t // ns) * ns * 16 + t % ns + k * ns] = v
            v = buf[..., t + g * k]
    assert off == len(tw) or len(radices) == 1
    out = np.empty(x.shape, complex)
    out[..., t + g * k] = v
    return out


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_fft_passes_and_twiddle_table(n):
    """K2's radices (16 a pass, the last 2, 4, 8 or 16) and its host
    twiddle table (float64 rounded to complex64) give the DFT of n points
    both ways, unnormalised, through the kernel's Stockham indexing."""
    assert np.prod(tss._fft_passes(n)) == n
    assert tss._twiddles(n).dtype == np.complex64
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    for inverse, want in ((False, np.fft.fft(x)), (True, n * np.fft.ifft(x))):
        got = _stockham(x, inverse)
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_cpu_rollout_takes_any_n():
    """The plain path steps any n, the sizes the card's K2 refuses included."""
    n = 24
    grid = tgrids.Grid((n, n), domain=DOMAIN)
    assert not tss.advect_takes(n)
    x = np.random.default_rng(3).standard_normal((2, n, n))
    w0 = torch.from_numpy(np.fft.rfft2(x).astype(np.complex64))
    kw = dict(grid=grid, fft_impl="dft_galerkin", device="cpu", viscosity=1e-3,
              mxu_precision="highest")
    fused, _ = teq.NavierStokes2DSpectral(fused=True, **kw).forward(w0, DT, 3)
    plain, _ = teq.NavierStokes2DSpectral(**kw).forward(w0, DT, 3)
    assert _rel(fused.numpy(), plain.numpy()) < 5e-6


@pytest.mark.parametrize("layout", ["galerkin", "aligned"])
def test_kernel_operand_layouts(layout):
    """The kernels' copies of the constants: the FFTs' twiddle table and the
    four multipliers as (4, R, m) planes for K1, and no dense matrix for the
    kernels: every axis is an FFT on the card, so F stays only for the plain
    version and its transpose is gone."""
    c = tss.constants(layout, TG, 1e-3, 0.0, DT, "cpu")
    assert "FT" not in c and tuple(c["F"].shape) == (c["R"], N)
    assert c["cf"].dtype == torch.float32 and tuple(c["cf"].shape) == (4, c["R"], c["m"])
    assert torch.equal(c["tw"], torch.from_numpy(tss._twiddles(N)))
    assert not {"il", "GT", "cf4"} & set(c)
    assert all(c[k].is_contiguous() for k in ("cf", "tw"))
