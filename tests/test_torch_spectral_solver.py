"""The port's grids, spectral ops, forcings, solver and trajectories vs JAX.

Every case feeds both packages the same numpy input. fp64 rollouts are held
to rtol 1e-9, the JAX suite's own tolerance for its transform paths
(tests/test_spectral_solver.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import grids as jgrids
from tpu_cfd.ops import spectral as jspectral
from tpu_cfd.solvers import equations as jeq, forcings as jforce
from tpu_cfd.solvers import trajectories as jtraj
from tpu_cfd_torch import grids as tgrids
from tpu_cfd_torch.ops import spectral as tspectral
from tpu_cfd_torch.solvers import equations as teq, forcings as tforce
from tpu_cfd_torch.solvers import trajectories as ttraj

torch.set_num_threads(2)

N = 32
DT = 1e-3
DOMAIN = ((0, 2 * np.pi), (0, 2 * np.pi))


def _grids(n=N):
    return jgrids.Grid((n, n), domain=DOMAIN), tgrids.Grid((n, n), domain=DOMAIN)


def _spectrum(batch, dtype=np.float64, seed=0, n=N):
    """A smooth random vorticity spectrum, (batch..., n, n//2+1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*batch, n, n))
    xh = np.fft.rfft2(x)
    k = np.sqrt(np.fft.fftfreq(n)[:, None] ** 2 + np.fft.rfftfreq(n)[None] ** 2) * n
    xh = xh * np.exp(-((k / 4) ** 2))
    return xh.astype(np.complex128 if dtype == np.float64 else np.complex64)


def _forcings(forced, jg, tg):
    if not forced:
        return None, None
    return (jforce.KolmogorovForcing(grid=jg, wave_number=2),
            tforce.KolmogorovForcing(grid=tg, wave_number=2))


def _pair(jg, tg, forced=False, **kw):
    fj, ft = _forcings(forced, jg, tg)
    if forced:
        kw.setdefault("drag", 0.1)
        kw.setdefault("viscosity", 1e-2)
    kw.setdefault("viscosity", 1e-3)
    jsolver = kw.pop("jsolver", None)
    tsolver = kw.pop("tsolver", None)
    nj = jeq.NavierStokes2DSpectral(grid=jg, forcing_fn=fj, dtype=jnp.float64,
                                    solver=jsolver, **kw)
    nt = teq.NavierStokes2DSpectral(grid=tg, forcing_fn=ft, dtype=torch.float64,
                                    solver=tsolver, device="cpu", **kw)
    return nj, nt


class TestGridsAndOps:
    def test_grid_meshes_match_jax(self):
        jg, tg = _grids(16)
        assert tg.step == jg.step and tg.domain == jg.domain
        assert tg.cell_faces == jg.cell_faces and tg.cell_center == jg.cell_center
        for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
            for a, b in zip(jg.mesh(dtype=dt_j), tg.mesh(dtype=dt_t)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            for a, b in zip(jg.rfft_mesh(dtype=dt_j), tg.rfft_mesh(dtype=dt_t)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            for a, b in zip(jg.mesh((0.0, 1.0), dtype=dt_j),
                            tg.mesh((0.0, 1.0), dtype=dt_t)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())

    @pytest.mark.parametrize("n", [12, 32, 33])
    def test_brick_wall_filter_matches_jax(self, n):
        jg, tg = _grids(n)
        np.testing.assert_array_equal(
            np.asarray(jspectral.brick_wall_filter_2d(jg)),
            tspectral.brick_wall_filter_2d(tg).numpy())

    def test_vorticity_to_velocity_and_curl_match_jax(self):
        jg, tg = _grids()
        w = _spectrum((2,))
        (uj, vj), pj = jspectral.vorticity_to_velocity(jg, jnp.asarray(w))
        (ut, vt), pt = tspectral.vorticity_to_velocity(tg, torch.from_numpy(w))
        for a, b in ((uj, ut), (vj, vt), (pj, pt)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
        mesh_j = jg.rfft_mesh(dtype=jnp.float64)
        mesh_t = tg.rfft_mesh(dtype=torch.float64)
        np.testing.assert_allclose(
            tspectral.spectral_curl_2d((ut, vt), mesh_t).numpy(),
            np.asarray(jspectral.spectral_curl_2d((uj, vj), mesh_j)),
            rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(
            tspectral.spectral_laplacian_2d(mesh_t).numpy(),
            np.asarray(jspectral.spectral_laplacian_2d(mesh_j)))

    @pytest.mark.parametrize("cls", ["KolmogorovForcing", "SinCosForcing"])
    @pytest.mark.parametrize("swap_xy", [False, True])
    def test_forcings_match_jax(self, cls, swap_xy):
        jg, tg = _grids()
        diam = 2 * np.pi
        fj = getattr(jforce, cls)(grid=jg, diam=diam, swap_xy=swap_xy, wave_number=2)
        ft = getattr(tforce, cls)(grid=tg, diam=diam, swap_xy=swap_xy, wave_number=2)
        for vort in (False, True):
            fj.vorticity = ft.vorticity = vort
            a = fj(jg, None, dtype=jnp.float64)
            b = ft(tg, None, dtype=torch.float64)
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            for x, y in zip(a, b):
                assert x.offset == y.offset
                np.testing.assert_allclose(y.data.numpy(), np.asarray(x.data),
                                           rtol=1e-12, atol=1e-12)


class TestSolverParity:
    @pytest.mark.parametrize("impl", ["fft", "dft", "dft_aligned", "dft_galerkin"])
    @pytest.mark.parametrize("forced", [False, True])
    @pytest.mark.parametrize("batch", [(), (2,)])
    def test_rollout_matches_jax(self, impl, forced, batch):
        jg, tg = _grids()
        nj, nt = _pair(jg, tg, forced, fft_impl=impl)
        w0 = _spectrum(batch)
        wj, dj = jax.jit(lambda w: nj.forward(w, DT, 4))(jnp.asarray(w0))
        wt, dt_ = nt.forward(torch.from_numpy(w0), DT, 4)
        assert tuple(wt.shape) == w0.shape
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("order", [1, 1.5, 2])
    def test_imex_orders_match_jax(self, order):
        jg, tg = _grids()
        nj, nt = _pair(jg, tg, True, jsolver=jeq.IMEXStepper(order=order),
                       tsolver=teq.IMEXStepper(order=order))
        w0 = _spectrum((2,), seed=1)
        wj, _ = jax.jit(lambda w: nj.forward(w, DT, 3))(jnp.asarray(w0))
        wt, _ = nt.forward(torch.from_numpy(w0), DT, 3)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9, atol=1e-11)

    def test_classic_rk4_matches_jax(self):
        jg, tg = _grids()
        nj, nt = _pair(
            jg, tg, jsolver=jeq.RK4CrankNicolsonStepper(low_storage=False),
            tsolver=teq.RK4CrankNicolsonStepper(low_storage=False))
        w0 = _spectrum((2,), seed=2)
        wj, _ = jax.jit(lambda w: nj.forward(w, DT, 3))(jnp.asarray(w0))
        wt, _ = nt.forward(torch.from_numpy(w0), DT, 3)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-9, atol=1e-11)

    def test_unsupported_imex_order_raises(self):
        _, tg = _grids()
        nt = teq.NavierStokes2DSpectral(viscosity=1e-3, grid=tg, device="cpu",
                                        dtype=torch.float64,
                                        solver=teq.IMEXStepper(order=3))
        with pytest.raises(ValueError, match="order"):
            nt.forward(torch.from_numpy(_spectrum(())), DT)

    def test_stable_time_step_matches_jax(self):
        for kw in (dict(dx=0.1), dict(dx=0.1, dt=0.01),
                   dict(dx=0.05, implicit_diffusion=False, max_velocity=2.0)):
            assert teq.stable_time_step(**kw) == jeq.stable_time_step(**kw)


class TestLayouts:
    @pytest.mark.parametrize("impl,height,width", [
        ("dft_aligned", N, N // 2), ("dft_galerkin", 20, 11), ("fft", N, N // 2 + 1)])
    def test_align_unalign_widths(self, impl, height, width):
        jg, tg = _grids()
        nj, nt = _pair(jg, tg, fft_impl=impl)
        w = _spectrum((2,))
        a_t = nt._align(torch.from_numpy(w))
        a_j = nj._align(jnp.asarray(w))
        assert tuple(a_t.shape[-2:]) == (height, width) == a_j.shape[-2:]
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        back_t = nt._unalign(a_t, w.shape[-2:]).numpy()
        np.testing.assert_array_equal(back_t, np.asarray(nj._unalign(a_j, w.shape[-2:])))
        # the internal layout passes through unchanged
        assert nt._align(a_t).shape == a_t.shape
        assert nt._unalign(a_t, a_t.shape[-2:]).shape == a_t.shape

    def test_constructor_errors(self):
        _, tg = _grids()
        kw = dict(viscosity=1e-3, grid=tg, device="cpu")
        with pytest.raises(ValueError, match="dft_aligned"):
            teq.NavierStokes2DSpectral(fused=True, fft_impl="fft", **kw)
        with pytest.raises(ValueError, match="fp32"):
            teq.NavierStokes2DSpectral(fused=True, fft_impl="dft_galerkin",
                                       dtype=torch.float64, **kw)
        with pytest.raises(ValueError, match="smooth"):
            teq.NavierStokes2DSpectral(fused=True, fft_impl="dft_aligned",
                                       smooth=False, **kw)
        with pytest.raises(ValueError, match="RK4-CN"):
            teq.NavierStokes2DSpectral(fused=True, fft_impl="dft_aligned",
                                       solver=teq.IMEXStepper(), **kw)
        with pytest.raises(ValueError, match="unknown fft_impl"):
            teq.NavierStokes2DSpectral(fft_impl="cufft", **kw)
        with pytest.raises(ValueError, match="smooth"):
            teq.NavierStokes2DSpectral(fft_impl="dft_galerkin", smooth=False, **kw)
        with pytest.raises(ValueError, match="precision"):
            teq.NavierStokes2DSpectral(fft_impl="dft", mxu_precision="tf32", **kw)

    def test_default_device_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _, tg = _grids()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teq.NavierStokes2DSpectral(viscosity=1e-3, grid=tg)

    def test_recommended_fft_impl(self):
        # the fused kernel on the Galerkin block wherever it steps the run
        assert teq.recommended_fft_impl(256, 32) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(256, 8) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(64, 1) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(128, 128) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(64, 32) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(256, 128) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(512, 8) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(512, 32) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(1024, 32) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(128, 8) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(4096, 1) == "fft"
        assert teq.recommended_fft_impl(256, 32, double=True) == "fft"
        assert teq.recommended_fft_impl(256, 32, dealias=False) == "fft"

    def test_recommended_fft_impl_needs_a_size_the_kernel_takes(self):
        # the fused rollout's kernels take n a power of two from 16 to 2048;
        # elsewhere the default is torch.fft, at any batch
        for n, b in ((96, 32), (96, 8), (200, 8), (3000, 32), (4096, 1)):
            assert teq.recommended_fft_impl(n, b) == "fft"
            assert teq.recommended_fft_impl(2 ** (n.bit_length() - 1), b) == (
                "dft_galerkin_fused" if n < 4096 else "fft")

    # the (n, b) points of ``route_times.py --sweep solver``
    @pytest.mark.parametrize("n,b", [(n, b) for n in (64, 128, 256, 512, 1024)
                                     for b in (8, 32, 128)])
    def test_route_rule_at_the_swept_points(self, n, b):
        from tpu_cfd_torch.data import generate as tgen

        assert teq.recommended_fft_impl(n, b) == "dft_galerkin_fused"
        assert teq.recommended_fft_impl(n, b, double=True) == "fft"
        assert teq.recommended_fft_impl(n, b, dealias=False) == "fft"
        assert tgen.default_fft_impl(n, b, False, True, fused_ok=True) == "dft_galerkin_fused"
        assert tgen.default_fft_impl(n, b, False, True, fused_ok=False) == "fft"

    @pytest.mark.parametrize("n,want", [
        (8, "fft"), (16, "dft_galerkin_fused"), (96, "fft"),
        (2048, "dft_galerkin_fused"), (4096, "fft")])
    def test_route_rule_at_the_kernel_size_edges(self, n, want):
        for b in (1, 32, 4096):
            assert teq.recommended_fft_impl(n, b) == want

    def test_route_sweep_lists_the_slow_defaults(self):
        # route_times.py --sweep solver lists the points where the rule's
        # route is more than 5 % slower than the fastest, or was not timed,
        # and those where fft is more than 5 % slower than the fastest route
        # without the kernel
        from tpu_cfd_torch.ops.cuda import route_times

        def row(n, rec, **ms):
            r = {"n": n, "b": 32, "recommended": rec,
                 **{k: {"ms_per_step": t} for k, t in ms.items()}}
            unfused = [k for k in ms if not k.endswith("_fused")]
            return {**r, "fastest": min(ms, key=ms.get),
                    "fastest_unfused": min(unfused, key=ms.get)}

        rows = [row(64, "dft_galerkin_fused", dft_galerkin_fused=1.0,
                    dft_aligned_fused=0.96, fft=1.3),          # 4 % slower: kept
                row(128, "dft_galerkin_fused", dft_galerkin_fused=1.0, fft=0.94),
                row(256, "fft", fft=1.0, dft_galerkin=2.0),
                {**row(512, "dft_galerkin_fused", fft=1.0),
                 "dft_galerkin_fused": {"out_of_memory": "CUDA out of memory"}},
                row(1024, "dft_galerkin_fused", dft_galerkin_fused=1.0, fft=1.5,
                    dft_galerkin=1.2)]
        slow = route_times.slow_defaults(rows)
        assert [(s["n"], s["default"], s["fastest"]) for s in slow] == [
            (128, "dft_galerkin_fused", "fft"), (512, "dft_galerkin_fused", "fft"),
            (1024, "fft", "dft_galerkin")]
        assert slow[0]["ratio"] == pytest.approx(1 / 0.94) and slow[1]["ratio"] is None
        assert slow[2]["ratio"] == pytest.approx(1.25)

    def test_fused_refusal_names_the_first_broken_requirement(self):
        f32 = torch.float32
        assert teq.fused_refusal(None, f32, True) is None
        assert teq.fused_refusal(teq.RK4CrankNicolsonStepper(), f32, True,
                                 "dft_galerkin") is None
        assert "RK4-CN" in teq.fused_refusal(teq.IMEXStepper(order=2), f32, True)
        assert "RK4-CN" in teq.fused_refusal(
            teq.RK4CrankNicolsonStepper(low_storage=False), f32, True)
        # the checks run in the constructor's order: layout, smooth, dtype, stepper
        assert "dft_aligned" in teq.fused_refusal(
            teq.IMEXStepper(), torch.float64, False, "fft")
        assert "smooth" in teq.fused_refusal(teq.IMEXStepper(), torch.float64, False)
        assert "fp32" in teq.fused_refusal(teq.IMEXStepper(), torch.float64, True)


class TestTrajectories:
    def test_trajectory_imex_matches_jax(self):
        jg, tg = _grids()
        nj, nt = _pair(jg, tg, fft_impl="fft")
        w0 = _spectrum((2,), seed=3)
        rj = jtraj.get_trajectory_imex(nj, jnp.asarray(w0), DT, num_steps=7,
                                       record_every_steps=3)
        rt = ttraj.get_trajectory_imex(nt, torch.from_numpy(w0), DT, num_steps=7,
                                       record_every_steps=3)
        assert rt.keys() == rj.keys()
        for k in rj:
            assert tuple(rt[k].shape) == rj[k].shape == (2, 3, N, N // 2 + 1)
            np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                       rtol=1e-9, atol=1e-9)

    def test_chunked_equals_single_with_postprocess(self):
        _, tg = _grids()
        nt = teq.NavierStokes2DSpectral(viscosity=1e-3, grid=tg, device="cpu",
                                        dtype=torch.float64)
        w0 = torch.from_numpy(_spectrum((2,), seed=4))
        single = ttraj.get_trajectory_imex(nt, w0, DT, num_steps=9,
                                           record_every_steps=2,
                                           fields=("vorticity", "vort_t"))
        chunked, w_end = ttraj.get_trajectory_imex_chunked(
            nt, w0, DT, num_steps=9, record_every_steps=2,
            fields=("vorticity", "vort_t"), records_per_chunk=2,
            postprocess=lambda r: {k: torch.fft.irfft2(v, s=(N, N)) for k, v in r.items()})
        for k in single:
            ref = torch.fft.irfft2(single[k], s=(N, N)).numpy()
            np.testing.assert_allclose(chunked[k], ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(w_end.numpy(), single["vorticity"][:, -1].numpy(),
                                   rtol=1e-12, atol=1e-12)
        with pytest.raises(ValueError, match="unknown"):
            ttraj.get_trajectory_imex(nt, w0, DT, fields=("pressure",))

    @pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
    def test_backdiff_matches_jax(self, order):
        x = np.random.default_rng(order).standard_normal((3, 8))
        np.testing.assert_allclose(
            ttraj.backdiff(torch.from_numpy(x), order).numpy(),
            np.asarray(jtraj.backdiff(jnp.asarray(x), order)), rtol=1e-12)

    def test_update_residual_matches_jax(self):
        w, wt = _spectrum((2,), seed=5), _spectrum((2,), seed=6)
        f = _spectrum((), seed=7)
        mesh_j = jtraj.default_rfft_mesh(N, 2 * np.pi, dtype=jnp.float64)
        lap_j = jtraj.spectral_laplacian_guarded(mesh_j)
        filt_j = jtraj.default_dealias_filter(*mesh_j, N)
        ref = jtraj.update_residual(jnp.asarray(w), jnp.asarray(wt), jnp.asarray(f),
                                    1e-3, mesh_j, lap_j, filt_j)
        mesh_t = tuple(torch.from_numpy(np.array(a)) for a in mesh_j)
        ours = ttraj.update_residual(
            torch.from_numpy(w), torch.from_numpy(wt), torch.from_numpy(f), 1e-3,
            mesh_t, torch.from_numpy(np.array(lap_j)),
            torch.from_numpy(np.array(filt_j)))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-9)
