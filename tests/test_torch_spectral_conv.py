"""The port's fused spectral conv (models/fused_conv.py) vs the JAX Pallas one.

On the CPU the DFT kernels run their plain PyTorch versions; they are held
against ``tpu_cfd.models.pallas_conv.fused_spectral_conv_s`` in interpret
mode (as tests/test_pallas_conv.py runs it), on the same numpy inputs and
flax parameters carried across by ``tpu_cfd_torch.convert``: values to
1e-5 and gradients (input and real-pair weights) to 1e-4 of the largest
reference entry, the tolerances of tests/test_pallas_conv.py. Gradients are
compared through real quantities only, where PyTorch's complex-gradient
convention and JAX's agree. The CUDA kernels run only on the card:
tests/test_torch_cuda_kernels.py holds them against the plain versions
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd.models.pallas_conv import fused_spectral_conv_s as jax_fused
from tpu_cfd.models.sfno import SpectralConvS as JaxConvS
from tpu_cfd_torch import convert
from tpu_cfd_torch.models.fused_conv import fused_spectral_conv_s, make_dft2d_ops
from tpu_cfd_torch.models.sfno import SpectralConvS
from tpu_cfd_torch.ops.cuda import spectral_conv as sc

torch.set_num_threads(2)

CASES = {
    "bias": dict(b=2, nx=16, ny=16, nt=6, ci=4, co=5, modes=(4, 4, 3), bias=True),
    "no_bias": dict(b=2, nx=16, ny=16, nt=6, ci=4, co=5, modes=(4, 4, 3), bias=False),
    "ci_ne_co_clipped_mt": dict(b=2, nx=16, ny=16, nt=4, ci=3, co=7,
                                modes=(4, 4, 5), bias=True),
    "nx_ne_ny": dict(b=1, nx=16, ny=12, nt=5, ci=2, co=3, modes=(4, 3, 3),
                     bias=True),
}


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _setup(case, seed=0):
    """Random flax params (non-zero bias) and input; the port's conv loaded."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((case["b"], case["nx"], case["ny"], case["nt"],
                             case["ci"])).astype(np.float32)
    jconv = JaxConvS(in_channels=case["ci"], out_channels=case["co"],
                     modes=case["modes"], bias=case["bias"], impl="dft")
    shapes = jax.eval_shape(jconv.init, jax.random.PRNGKey(0), v)["params"]
    params = {k: (rng.uniform(0, 0.05, s.shape) if k.startswith("weight")
                  else rng.standard_normal(s.shape)).astype(np.float32)
              for k, s in shapes.items()}
    tconv = SpectralConvS(case["ci"], case["co"], case["modes"], bias=case["bias"])
    tconv.load_state_dict(convert.state_dict_from_flax("SpectralConv", params))
    return jconv, params, tconv, v, rng


def _jax_out_and_grads(jconv, params, v, r):
    def loss(v_, p_):
        w = jconv.apply({"params": p_}, method=lambda m: m.compact_weight())
        bc = (jconv.apply({"params": p_}, method=lambda m: m.compact_bias())
              if jconv.bias else None)
        out = jax_fused(v_, w, bc, jconv.modes, delta=jconv.delta, interpret=True)
        return (out * r).sum(), out

    (_, out), (gv, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(v), jax.tree_util.tree_map(jnp.asarray, params))
    return np.asarray(out), np.asarray(gv), {k: np.asarray(g) for k, g in gp.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_conv_matches_jax_pallas(name):
    case = CASES[name]
    jconv, params, tconv, v, rng = _setup(case)
    r = rng.standard_normal((case["b"], case["nx"], case["ny"], case["nt"],
                             case["co"])).astype(np.float32)
    out_j, gv_j, gp_j = _jax_out_and_grads(jconv, params, v, r)

    vt = torch.from_numpy(v).requires_grad_(True)
    out_t = tconv(vt)   # float32, dft, backward norm: the fused route
    (out_t * torch.from_numpy(r)).sum().backward()

    assert out_t.shape == out_j.shape
    assert _rel_err(out_t.detach(), out_j) < 1e-5
    assert _rel_err(vt.grad, gv_j) < 1e-4
    grads = dict(tconv.named_parameters())
    for k, g in gp_j.items():
        assert _rel_err(grads[k].grad, g) < 1e-4, k


def test_fused_route_matches_dft_apply():
    """The port's fused route and its own einsum ``_dft_apply`` agree."""
    _, _, tconv, v, _ = _setup(CASES["bias"], seed=3)
    x = torch.from_numpy(v)
    assert _rel_err(tconv(x).detach(), tconv._dft_apply(x).detach()) < 1e-5


def test_plain_functions_gradcheck_fp64():
    """The plain modes/inverse Functions' backwards are their exact adjoints
    under PyTorch's complex convention (each launches the other)."""
    modes, inverse = make_dft2d_ops(6, 5, 2, 2, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(1, 2, 6, 5, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(modes, (v,))
    g = torch.randn(1, 2, 4, 4, dtype=torch.complex128, generator=gen,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda g_: inverse(g_, 0.3), (g,))


def test_backward_runs_the_partner_transform(monkeypatch):
    calls = []
    for name in ("modes", "inverse"):
        monkeypatch.setattr(sc, name, lambda *a, _n=name, _f=getattr(sc, name):
                            calls.append(_n) or _f(*a))
    modes, inverse = make_dft2d_ops(8, 8, 2, 2, "cpu")
    v = torch.randn(1, 1, 8, 8, requires_grad=True)
    inverse(modes(v), 1 / 64).sum().backward()
    assert calls == ["modes", "inverse", "modes", "inverse"]


def test_non_cpu_tensors_never_fall_back():
    c = {"FyT": torch.zeros(8, 4, dtype=torch.complex64),
         "FxT": torch.zeros(8, 4, dtype=torch.complex64)}
    with pytest.raises(ValueError, match="no spectral-conv kernel"):
        sc.modes(torch.zeros(1, 1, 8, 8, device="meta"), c)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sc._launch_modes(torch.zeros(1, 1, 8, 8), c)
    with pytest.raises(ValueError, match="float32-only"):
        fused_spectral_conv_s(torch.zeros(1, 8, 8, 4, 2, dtype=torch.float64),
                              torch.zeros(4, 4, 3, 2, 2, dtype=torch.complex128),
                              None, (2, 2, 3))


def test_flops_at_the_recipe():
    # b=64, P = 10 steps x 10 channels, 64^2, 2m = 64: a real FFT of each
    # plane (2.5 N log2 N) needs fewer than the dense 6.7 + 13.4 GFLOP, and
    # is the count the bound in chip_smoke.py uses
    assert sc.flops(64 * 100, 64, 64, 64, 64) == 786_432_000
    # few modes: the dense truncated DFT is the cheaper one
    assert sc.flops(1, 64, 64, 2, 2) == 4 * 64 * 64 * 2 + 8 * 2 * 64 * 2


def test_fused_modes_route_by_shape():
    """The fused dft2d_modes kernel takes the recipe's (64^2, m = 32) and the
    optimizer sweep's (64^2, m = 12) shapes and fits one block of 227 KB of
    shared memory; 256^2 goes to the two-pass route. The tensor cores compute
    the my = my2 / 2 rows y >= 0 (a real input mirrors the rest), on as many
    planes at once as give 8 tiles; strides are 4, 8, 16 and 8 mod 32 words
    (conflict-free fragment loads)."""
    ints, nbytes = sc.fused_modes_layout(64, 64, 64, 64)
    assert nbytes == 218_112 <= sc.FUSED_SMEM_LIMIT
    assert ints == (64, 64, 64, 64, 2, 64, 64, 64, 32, 128, 64, 68, 72, 80, 136)
    sweep = sc.fused_modes_layout(64, 64, 24, 24)
    assert sweep is not None and sweep[0][4] == 3 and sweep[1] == 224_256
    assert sc.fused_modes_layout(256, 256, 64, 64) is None
    assert sc.fused_modes_layout(64, 62, 64, 64) is None   # rows not 16-byte pieces
    for shape in ((64, 64, 64, 64), (64, 64, 24, 24), (16, 12, 6, 8), (96, 96, 32, 32)):
        ints, nbytes = sc.fused_modes_layout(*shape)
        nx, ny, my2, mx2, pp, k1, m1, n1, m2, n2, xr, sv, sy, sh, sx = ints
        my = my2 // 2
        assert (sv % 32, sy % 32, sh % 32, sx % 32) == (4, 8, 16, 8)
        assert k1 >= ny and k1 % 8 == 0 and m1 >= nx and m1 % 32 == 0
        assert n1 >= 2 * my and n2 >= 2 * mx2 and n1 % 32 == n2 % 32 == 0
        assert m2 >= my and m2 % 32 == 0 and xr >= nx and xr % 4 == 0
        assert sv >= k1 and sy >= n1 and sh >= max(n1 + 2, 2 * m2) and sx >= n2
        size = lambda pp: 4 * (2 * pp * m1 * sv + 2 * k1 * sy + 2 * xr * sx  # noqa: E731
                               + pp * m1 * sh + 2 * ny + 2 * nx)
        assert nbytes == size(pp)
        # 8 tiles of 32 x 32 for the x-contraction, unless one plane more
        # would not fit (the sweep's 3 planes, 96^2's 1)
        if pp * (m2 // 32) * (n2 // 32) < 8:
            assert size(pp + 1) > sc.FUSED_SMEM_LIMIT
    # just over the budget at 96^2: m = 16 fits, m = 20 does not
    assert sc.fused_modes_layout(96, 96, 32, 32)[1] <= sc.FUSED_SMEM_LIMIT
    assert sc.fused_modes_layout(96, 96, 40, 40) is None


@pytest.mark.parametrize("n,m,route", [(64, 32, "fused"), (64, 12, "fused"),
                                       (256, 32, "two_pass")])
def test_launch_modes_takes_the_route_of_its_shape(monkeypatch, n, m, route):
    taken = []
    monkeypatch.setattr(sc, "_launch_modes_fused",
                        lambda v, c, layout: taken.append("fused"))
    monkeypatch.setattr(sc, "_launch_modes_two_pass",
                        lambda v, c: taken.append("two_pass"))
    c = {"FyT": torch.zeros(n, 2 * m, dtype=torch.complex64),
         "FxT": torch.zeros(n, 2 * m, dtype=torch.complex64)}
    sc._launch_modes(torch.zeros(1, 2, n, n), c)
    assert taken == [route]


def test_fused_inverse_route_by_shape():
    """The fused dft2d_inverse kernel takes the recipe's (64^2, m = 32) and the
    sweep's (64^2, m = 12) shapes within one block's 227 KB; 256^2 and an odd
    row length go to the two-pass route. Each warp holds at most one 32 x 32
    tile of Q (pp my folded rows x 2nx), and the strides are 4, 8, 4 and 8
    mod 32 words (conflict-free fragment loads)."""
    ints, nbytes = sc.fused_inverse_layout(64, 64, 64, 64)
    assert nbytes == 209_408 <= sc.FUSED_SMEM_LIMIT
    assert ints == (64, 64, 64, 64, 2, 64, 64, 128, 64, 64, 64, 132, 136, 68, 72, 8704)
    ints, nbytes = sc.fused_inverse_layout(64, 64, 24, 24)
    assert ints[4] == 4 and nbytes == 98_688
    assert sc.fused_inverse_layout(256, 256, 64, 64) is None
    assert sc.fused_inverse_layout(64, 63, 64, 64) is None   # odd rows: no float2 stores
    for shape in ((64, 64, 64, 64), (64, 64, 24, 24), (16, 12, 6, 8), (96, 96, 40, 40)):
        ints, nbytes = sc.fused_inverse_layout(*shape)
        nx, ny, my2, mx2, pp, r1, kr, n1, m2, k2, n2, sg, sx, sq, sy, gsz = ints
        my = my2 // 2
        assert (sg % 32, sx % 32, sq % 32, sy % 32) == (4, 8, 4, 8)
        assert r1 >= pp * my and r1 % 32 == 0 and (r1 // 32) * (n1 // 32) <= 8
        assert kr >= mx2 and kr % 4 == 0 and n1 >= 2 * nx and n1 % 32 == 0
        assert m2 >= nx and m2 % 32 == 0 and k2 >= 2 * my and k2 % 8 == 0
        assert n2 >= ny and n2 % 32 == 0 and sg >= 2 * kr and sq >= k2
        assert sx >= n1 and sy >= n2 and gsz >= max(r1 * sg, pp * m2 * sq)
        assert nbytes == 4 * (2 * pp * my2 * mx2 + gsz + 2 * kr * sx + 2 * k2 * sy
                              + 2 * (pp * nx + pp * my + nx + ny)) <= sc.FUSED_SMEM_LIMIT


@pytest.mark.parametrize("n,m,route", [(64, 32, "fused"), (64, 12, "fused"),
                                       (256, 32, "two_pass")])
def test_launch_inverse_takes_the_route_of_its_shape(monkeypatch, n, m, route):
    taken = []
    monkeypatch.setattr(sc, "_launch_inverse_fused",
                        lambda g, s, c, layout: taken.append("fused"))
    monkeypatch.setattr(sc, "_launch_inverse_two_pass",
                        lambda g, s, c: taken.append("two_pass"))
    c = {"GxT": torch.zeros(2 * m, n, dtype=torch.complex64),
         "GyT": torch.zeros(2 * m, n, dtype=torch.complex64)}
    sc._launch_inverse(torch.zeros(1, 2, 2 * m, 2 * m, dtype=torch.complex64), 1.0, c)
    assert taken == [route]


def _inverse_folded(g, scale, c):
    """The fused inverse kernel's arithmetic in torch: each mode folded with
    its mirror (row 0 at weight 1/2), the tensor cores' two products on the
    my rows y' >= 0, and the sums the kernel does on the CUDA cores: the
    mirrors of column -mx and row -my."""
    my, mx = g.shape[-2] // 2, g.shape[-1] // 2
    ky, kx = torch.arange(my), torch.arange(2 * mx)
    mirror_y = torch.where(ky == 0, 0, 2 * my - ky)
    mirror_x = torch.where(kx == 0, 0, 2 * mx - kx)
    gm = g[..., mirror_y[:, None], mirror_x].conj()
    gf = g[..., :my, :] + gm
    gf[..., 0, :] = gf[..., 0, :] / 2
    gf[..., mx] = g[..., :my, mx]                       # column -mx: no mirror
    gxt, gyt = c["GxT"], c["GyT"]
    q = gf @ gxt                                        # (.., my, nx)
    q[..., 1:, :] += gm[..., 1:, mx, None] * gxt[mx].conj()   # its mirrors
    qm = g[..., my, :] @ gxt                            # row -my (.., nx)
    b3 = torch.stack([gyt[:my].real, -gyt[:my].imag], dim=-2).reshape(2 * my, -1)
    qt = torch.view_as_real(q.transpose(-1, -2).contiguous()).flatten(-2)  # (.., nx, 2my)
    out = qt @ b3 + (qm[..., :, None] * gyt[my]).real
    return scale * out


@pytest.mark.parametrize("n,m", [(64, 32), (64, 12), (16, 6)])
def test_folded_inverse_matches_plain(n, m):
    """The fold is exact for any input, Hermitian or not: on random complex128
    modes it equals the plain inverse to rounding."""
    from tpu_cfd_torch.models.fused_conv import _dft2d_constants
    c = _dft2d_constants(n, n, m, m, "cpu", "complex128")
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((2, 3, 2 * m, 2 * m))
                         + 1j * rng.standard_normal((2, 3, 2 * m, 2 * m)))
    idx = torch.cat([torch.zeros(1, dtype=torch.long), torch.arange(2 * m - 1, 0, -1)])
    assert _rel_err(g, g[..., idx[:, None], idx].conj().resolve_conj()) > 0.5  # not Hermitian
    want = sc._inverse_plain(g, 0.3, c)
    assert _rel_err(_inverse_folded(g, 0.3, c), want) < 1e-12
