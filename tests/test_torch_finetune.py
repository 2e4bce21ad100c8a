"""The port's fine-tuning pipeline against the JAX package, in fp64.

Shared numpy inputs made from a seed go through both packages
(``jax_enable_x64`` as ``tests/conftest.py`` sets it), at 32² unless named:

- ``imex_crank_nicolson_step``'s five outputs, each within 1e-12 of the
  largest entry of ∂w/∂t (the largest term; the residual is a small
  difference of such terms), and ``get_trajectory_imex_crank_nicolson``
  over 10 records within 1e-10 of each field's largest entry;
- ``fine_tune_post``: ``w`` within 1e-12 of its largest entry; ``w_t`` and
  the residual within 1e-8 of the largest ``w_t`` (the ±dt difference
  divides by dt = 1e-6, so roundoff of the fields grows 10⁶-fold);
- ``OutConvFT`` with JAX's parameters carried across by ``convert.py``, at
  dt = 1e-3 (``FT``): its outputs to the same tolerances, the α-weighted
  H⁻¹ residual norm within 1e-8 relative, and its gradient with respect to
  every parameter (real pairs on both sides) within 1e-6 of the leaf's
  largest entry;
- three steps of ``groupwise_adam`` against ``optax.multi_transform``
  within 1e-10 of the largest move, and a 5-step ``finetune_steps`` history
  against JAX's within 1e-8 relative, its final parameters within 1e-6 of
  each leaf's largest entry (Adam scales a gradient's roundoff by lr/eps
  where |g| is near eps);
- ``BochnerNorm`` and ``ResidualLoss`` within 1e-12 relative;
- ``forward_with_latents`` against ``apply_with_latents`` in fp32, within
  1e-5 of each latent's largest entry (the SFNO tests' tolerance).

The two example entry points run end to end with ``--no-cuda`` at toy size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_cfd.models import sfno as jsfno
from tpu_cfd.models.base import apply_with_latents
from tpu_cfd.solvers import trajectories as jt
from tpu_cfd.train import finetune as jft, losses as jlosses
from tpu_cfd_torch import convert
from tpu_cfd_torch.models import SFNO, forward_with_latents
from tpu_cfd_torch.models.sfno import SpectralConvT
from tpu_cfd_torch.solvers import trajectories as tt
from tpu_cfd_torch.train import finetune as tft, losses as tlosses, pipeline

torch.set_num_threads(2)

N, NT = 32, 6
# dt 1e-3 where a residual norm is compared: with the symmetric BDF weights
# the residual is O(dt²), so at the examples' dt = 1e-6 it sits at fp64
# roundoff over dt (~1e-10 here) and two FFT libraries differ by ~1 % in
# its norm; at 1e-3 it is ~1e-4, far above that roundoff
FT = dict(delta=1.0, diam=1.0, visc=1e-3, dt=1e-3, bdf_weight=(0.5, 0.5))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _err(got, want, scale=None) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(got - want).max() / scale)


def _smooth_field(n, b=1, seed=0):
    """A band-limited random vorticity field ``(b, n, n)``."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(n, d=1 / n)
    kx, ky = np.meshgrid(k, np.fft.rfftfreq(n, d=1 / n), indexing="ij")
    spec = np.fft.rfft2(rng.standard_normal((b, n, n)))
    spec *= np.exp(-((kx ** 2 + ky ** 2) / 16.0))
    w = np.fft.irfft2(spec, s=(n, n))
    return w / np.abs(w).max() * 5.0


@functools.lru_cache(maxsize=None)
def _trajectory(n=N, nt=NT):
    """(1, n, n, nt) solver trajectory of the port's legacy CN rollout."""
    out = tt.get_trajectory_imex_crank_nicolson(
        _t(_smooth_field(n)[0]), torch.zeros(n, n, dtype=torch.float64),
        visc=1e-3, T=0.1, delta_t=1e-3, record_steps=nt)
    return np.moveaxis(out["vorticity"].numpy(), 0, -1)[None]


def _mesh(n, diam, module, dtype):
    mesh = module.default_rfft_mesh(n, diam, dtype=dtype)
    lap = module.spectral_laplacian_guarded(mesh)
    return mesh, lap, module.default_dealias_filter(*mesh, n)


@pytest.mark.parametrize("dealias", [False, True])
@pytest.mark.parametrize("diam", [1.0, 2 * np.pi])
def test_imex_crank_nicolson_step(dealias, diam):
    rng = np.random.default_rng(1)
    w_h = np.fft.rfft2(_smooth_field(N, b=2))
    f_h = np.fft.rfft2(rng.standard_normal((N, N)))
    want = jt.imex_crank_nicolson_step(jnp.asarray(w_h), jnp.asarray(f_h), 1e-3, 1e-3,
                                       diam=diam, dealias=dealias)
    got = tt.imex_crank_nicolson_step(_t(w_h), _t(f_h), 1e-3, 1e-3, diam=diam,
                                      dealias=dealias)
    scale = np.abs(np.asarray(want[1])).max()
    for g, w in zip(got, want):
        assert g.dtype == torch.complex128
        assert _err(g, w, scale) < 1e-12


def test_rfft_mesh_and_filters_match():
    for diam in (1.0, 2 * np.pi):
        mesh_j, lap_j, filt_j = _mesh(N, diam, jt, jnp.float64)
        mesh_t, lap_t, filt_t = _mesh(N, diam, tt, torch.float64)
        for a, b in zip(mesh_t + (lap_t,), mesh_j + (lap_j,)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(filt_t.numpy(), np.asarray(filt_j))
        assert filt_t.dtype == torch.bool


@pytest.mark.parametrize("subsample", [1, 2])
def test_legacy_trajectory(subsample):
    w0 = _smooth_field(N)[0]
    f = np.random.default_rng(3).standard_normal((N, N)) * 0.1
    kw = dict(visc=1e-3, T=0.02, delta_t=1e-3, record_steps=10, diam=1.0,
              subsample=subsample)
    want = jt.get_trajectory_imex_crank_nicolson(jnp.asarray(w0), jnp.asarray(f), **kw)
    got = tt.get_trajectory_imex_crank_nicolson(_t(w0), _t(f), **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape == (10, N // subsample, N // subsample)
        # the residual is a small difference of terms as large as ∂w/∂t
        scale = np.abs(np.asarray(want["vort_t" if key == "residual" else key])).max()
        assert _err(got[key], want[key], scale) < 1e-10, key


@pytest.mark.parametrize("forced", [False, True])
def test_fine_tune_post(forced):
    w = _trajectory()
    f = (np.random.default_rng(4).standard_normal((1, N, N)) * 0.1) if forced else None
    kw = dict(visc=1e-3, dt=1e-6, diam=1.0, bdf_weight=(0.5, 0.5))
    want = jft.fine_tune_post(jnp.asarray(w), None if f is None else jnp.asarray(f), **kw)
    got = tft.fine_tune_post(_t(w), None if f is None else _t(f), **kw)
    assert set(got) == {"w", "w_t", "residual"}
    for v in got.values():
        assert v.shape == w.shape and v.dtype == torch.float64
    assert _err(got["w"], want["w"]) < 1e-12
    scale = np.abs(np.asarray(want["w_t"])).max()
    assert _err(got["w_t"], want["w_t"], scale) < 1e-8
    assert _err(got["residual"], want["residual"], scale) < 1e-8


def _outconv_ft_pair(modes=(8, 8, 3), seed=0):
    """JAX OutConvFT params (perturbed off init) carried into the port."""
    w = _trajectory()
    v_latent, v_res = w[..., None], w
    jmod = jft.OutConvFT(*modes, out_steps=NT, **FT)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(v_latent), jnp.asarray(v_res),
                       None, out_steps=NT, original=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) * (1 + 0.1 * rng.standard_normal(p.shape))
        + 1e-3 * rng.standard_normal(p.shape), jax.device_get(params))
    tmod = tft.OutConvFT(*modes, out_steps=NT, **FT).double()
    tmod.load_state_dict(convert.state_dict_from_flax("OutConvFT", params))
    return jmod, tmod, params, v_latent, v_res


def _res_hm1(module):
    return module.SobolevLoss(n_grid=N, norm_order=-1, relative=False,
                              time_average=True, alpha=10 ** (-3 / 2),
                              freq_cutoff=N // 2 + 1, diam=1.0)


def test_outconv_ft_forward_and_residual_gradients():
    jmod, tmod, params, v_latent, v_res = _outconv_ft_pair()
    res_j = _res_hm1(jlosses)

    def loss(p):
        out = jmod.apply(p, jnp.asarray(v_latent), jnp.asarray(v_res), None, out_steps=NT)
        return res_j(out["residual"]), out

    (l_j, out_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    out_t = tmod(_t(v_latent), _t(v_res), None, out_steps=NT)
    l_t = _res_hm1(tlosses)(out_t["residual"])
    l_t.backward()

    assert _err(out_t["w"], out_j["w"]) < 1e-12
    scale = np.abs(np.asarray(out_j["w_t"])).max()
    assert _err(out_t["w_t"], out_j["w_t"], scale) < 1e-8
    assert _err(out_t["residual"], out_j["residual"], scale) < 1e-8
    assert abs(float(l_t.detach()) - float(l_j)) <= 1e-8 * abs(float(l_j))
    orig_j = jmod.apply(params, jnp.asarray(v_latent), jnp.asarray(v_res), None,
                        out_steps=NT, original=True)
    assert _err(tmod(_t(v_latent), _t(v_res), out_steps=NT, original=True), orig_j) < 1e-12

    grads = convert.state_dict_from_flax("OutConvFT", jax.device_get(g_j))
    named = dict(tmod.named_parameters())
    assert set(named) == set(grads)
    for name, p in named.items():
        assert _err(p.grad, grads[name]) < 1e-6, name


def test_outconv_ft_convert_round_trip():
    _, tmod, params, *_ = _outconv_ft_pair()
    back = convert.flax_from_state_dict("OutConvFT", tmod.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back)) == 8
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_transplant_spectral_weights():
    old_modes, new_modes = (3, 3, 2), (6, 6, 3)
    gen = torch.Generator().manual_seed(0)
    old = SpectralConvT(1, 1, old_modes, bias=True, temporal_padding=True)
    new = SpectralConvT(1, 1, new_modes, bias=True, temporal_padding=True)
    old.reset_parameters(gen)
    new.reset_parameters(gen)
    with torch.no_grad():
        for b in old.biases():
            b.normal_(generator=gen)
    before = {k: v.clone() for k, v in new.state_dict().items()}
    merged = tft.transplant_spectral_weights(old.state_dict(), new.state_dict(), old_modes)
    for k, v in new.state_dict().items():  # out of place
        assert torch.equal(v, before[k])
    mx, my, mt = old_modes
    corners = {0: (slice(0, mx), slice(0, my)), 1: (slice(-mx, None), slice(0, my)),
               2: (slice(0, mx), slice(-my, None)), 3: (slice(-mx, None), slice(-my, None))}
    for i, (sx, sy) in corners.items():
        for name in (f"weight_{i}", f"bias_{i}"):
            assert torch.equal(merged[name][sx, sy, :mt], old.state_dict()[name])
            rest = merged[name].clone()
            rest[sx, sy, :mt] = before[name][sx, sy, :mt]
            assert torch.equal(rest, before[name])
    # the same corners as the JAX package's transplant, on the same arrays
    want = jft.transplant_spectral_weights(
        {k: jnp.asarray(v.numpy()) for k, v in old.state_dict().items()},
        {k: jnp.asarray(v.numpy()) for k, v in before.items()}, old_modes)
    for k in want:
        np.testing.assert_array_equal(merged[k].numpy(), np.asarray(want[k]))


def test_build_finetune_outconv_init():
    sfno = SFNO(modes_x=4, modes_y=4, modes_t=2, width=4, latent_steps=4,
                num_spectral_layers=2, output_steps=NT)
    with torch.no_grad():
        for b in sfno.out_conv.conv.biases():
            b.normal_()
    model = tft.build_finetune_outconv(
        sfno.out_conv.conv, (4, 4, 2), (8, 8, 3), out_steps=NT,
        generator=torch.Generator().manual_seed(2), dtype=torch.float64, **FT)
    old = sfno.out_conv.conv.state_dict()
    fresh = tft.OutConvFT(8, 8, 3, out_steps=NT, **FT).conv
    fresh.reset_parameters(torch.Generator().manual_seed(2))
    for name, p in model.conv.state_dict().items():
        assert p.dtype == torch.float64
        i = int(name[-1])
        sx = slice(0, 4) if i % 2 == 0 else slice(-4, None)
        sy = slice(0, 4) if i < 2 else slice(-4, None)
        assert torch.equal(p[sx, sy, :2], old[name].double())
        rest = p.clone()
        rest[sx, sy, :2] = 0.0
        if name.startswith("bias"):
            assert torch.count_nonzero(rest) == 0
        else:
            want = (fresh.state_dict()[name] * 1e-6).double()
            want[sx, sy, :2] = 0.0
            assert torch.equal(rest, want)
            assert 0 < float(rest.abs().max()) < 1e-6


def test_groupwise_adam_matches_optax():
    rng = np.random.default_rng(5)
    shapes = {"weight_0": (3, 4, 2), "bias_0": (3, 2), "weight_1": (5,), "bias_1": (2, 2)}
    init = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) for k, s in shapes.items()} for _ in range(3)]
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    opt = jft.groupwise_adam(1e-4, 1e-1, params_j)
    state = opt.init(params_j)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        params_j = optax.apply_updates(params_j, updates)
    params_t = {k: torch.nn.Parameter(_t(v).clone()) for k, v in init.items()}
    opt_t = tft.groupwise_adam(1e-4, 1e-1, params_t.items())
    for g in grads:
        for k, p in params_t.items():
            p.grad = _t(g[k]).clone()
        opt_t.step()
    for k, p in params_t.items():
        step = np.abs(np.asarray(params_j[k]) - init[k]).max()
        assert _err(p, params_j[k], step) < 1e-10, k
    # the bias group moves 1e3 times faster
    assert (params_t["bias_0"] - _t(init["bias_0"])).abs().max() > 100 * (
        params_t["weight_0"] - _t(init["weight_0"])).abs().max()


def _jax_history(jmod, params, v_latent, v_res, **kw):
    return jft.finetune_steps(jmod, params, jnp.asarray(v_latent), jnp.asarray(v_res),
                              None, out_steps=NT, n_steps=5, **kw)


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("keep_best", [True, False])
def test_finetune_steps_history(tracked, keep_best):
    jmod, tmod, params, v_latent, v_res = _outconv_ft_pair(seed=1)
    w_gt = _trajectory()
    kw = dict(lr=1e-4, lr_bias=1e-2, keep_best=keep_best)
    track_j = (lambda o: {"l2": jnp.linalg.norm(o["w"] - w_gt)}) if tracked else None
    track_t = (lambda o: {"l2": torch.linalg.vector_norm(o["w"] - _t(w_gt))}) if tracked else None
    p_j, hist_j = _jax_history(jmod, params, v_latent, v_res, residual_norm=_res_hm1(jlosses),
                               track=track_j, **kw)
    hist_t = tft.finetune_steps(tmod, _t(v_latent), _t(v_res), None, out_steps=NT,
                                n_steps=5, residual_norm=_res_hm1(tlosses), track=track_t, **kw)
    assert len(hist_t) == len(hist_j) == 5 + keep_best
    for a, b in zip(hist_t, hist_j):
        if tracked:
            assert set(a) == set(b) == {"residual", "l2"}
            for k in a:
                assert isinstance(a[k], float)
                assert abs(a[k] - b[k]) <= 1e-8 * abs(b[k]), k
        else:
            assert isinstance(a, float) and abs(a - b) <= 1e-8 * abs(b)
    # the parameters left in the model: the best (or last) iterate, as JAX's.
    # Adam scales an entry's gradient error by lr/eps where |g| ~ eps, so the
    # parameters are held to 1e-6 of the leaf's largest entry
    sd = convert.state_dict_from_flax("OutConvFT", jax.device_get(p_j))
    for name, p in tmod.state_dict().items():
        assert _err(p, sd[name]) < 1e-6, name


def test_finetune_steps_default_norm_and_lr_decay():
    """The default Bochner norm, one lr group, and the exponential decay
    (``optax.exponential_decay(lr, n_steps, rate)``) against JAX."""
    jmod, tmod, params, v_latent, v_res = _outconv_ft_pair(seed=2)
    sched = optax.exponential_decay(1e-3, 5, 0.05)
    _, hist_j = _jax_history(jmod, params, v_latent, v_res, lr=sched)
    hist_t = tft.finetune_steps(tmod, _t(v_latent), _t(v_res), None, out_steps=NT,
                                n_steps=5, lr=1e-3, lr_decay=0.05)
    assert len(hist_t) == 6
    for a, b in zip(hist_t, hist_j):
        assert abs(a - b) <= 1e-8 * abs(b)


def test_finetune_steps_keep_best_keeps_a_copy():
    """The best iterate is a snapshot: the model ends at the best residual
    of the history, not at the last parameters."""
    _, tmod, _, v_latent, v_res = _outconv_ft_pair(seed=3)
    hist = tft.finetune_steps(tmod, _t(v_latent), _t(v_res), None, out_steps=NT,
                              n_steps=6, lr=0.5)
    i, best = tft.best_of(hist)
    with torch.no_grad():
        out = tmod(_t(v_latent), _t(v_res), None, out_steps=NT)
    norm = tlosses.BochnerNorm(n_grid=N, relative=False, time_last=True)
    assert i == 3 and best < hist[-1]  # lr 0.5 overshoots after three updates
    assert float(norm(out["residual"])) == pytest.approx(best, rel=1e-12)


@pytest.mark.parametrize("time_last", [False, True])
@pytest.mark.parametrize("dt", [None, 1e-2])
def test_bochner_norm(time_last, dt):
    u = np.random.default_rng(6).standard_normal((2, N, N, 5))
    if not time_last:
        u = np.moveaxis(u, -1, 1)
    kw = dict(n_grid=N, dt=dt, relative=False, time_last=time_last)
    want = jlosses.BochnerNorm(**kw)(jnp.asarray(u))
    got = tlosses.BochnerNorm(**kw)(_t(u))
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


@pytest.mark.parametrize("kind", ["trajectory", "noise", "forced"])
def test_residual_loss(kind):
    w = _trajectory(nt=8)
    rng = np.random.default_rng(7)
    if kind == "noise":
        w = rng.standard_normal(w.shape)
    f = rng.standard_normal(w.shape) if kind == "forced" else None
    kw = dict(n_grid=N, n_t=8, delta_t=1e-2)
    want = jlosses.ResidualLoss(**kw)(jnp.asarray(w), f=None if f is None else jnp.asarray(f))
    got = tlosses.ResidualLoss(**kw)(_t(w), f=None if f is None else _t(f))
    assert got.dtype == torch.float64
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


def test_residual_loss_with_stream_function():
    w = _trajectory(nt=8)
    psi = np.random.default_rng(8).standard_normal(w.shape)
    kw = dict(n_grid=N, n_t=8, delta_t=1e-2)
    want = jlosses.ResidualLoss(**kw)(jnp.asarray(w), psi=jnp.asarray(psi))
    got = tlosses.ResidualLoss(**kw)(_t(w), psi=_t(psi))
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


@pytest.mark.parametrize("layers", [1, 3])
def test_forward_with_latents(layers):
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=4, num_spectral_layers=layers,
              activation="GELU", beta=0.0, latent_steps=8, output_steps=10)
    v = np.random.default_rng(9).standard_normal((2, 16, 16, 10)).astype(np.float32)
    jmod = jsfno.SFNO(**kw)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), v)
    tmod = SFNO(**kw)
    tmod.load_state_dict(convert.sfno_state_dict_from_flax(jax.device_get(params)))
    out_j, lat_j = apply_with_latents(jmod, params, v)
    with torch.no_grad():
        out_t, lat_t = forward_with_latents(tmod, _t(v))
    assert set(lat_t) == set(lat_j) == {"lifting", "r", *(
        f"spectral_{i}" for i in range(layers - 1))}
    assert _err(out_t, out_j) < 1e-5
    for k in lat_j:
        assert lat_t[k].shape == lat_j[k].shape
        assert _err(lat_t[k], lat_j[k]) < 1e-5, k
    # the hooks are gone: a second call records nothing new
    assert not tmod.lifting._forward_hooks and not tmod.out_conv._forward_pre_hooks


def test_forward_with_latents_records_once_under_remat():
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=4, num_spectral_layers=3,
              latent_steps=8, output_steps=10)
    v = _t(np.random.default_rng(9).standard_normal((1, 16, 16, 10)).astype(np.float32))
    plain, remat = SFNO(**kw), SFNO(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    out_a, lat_a = forward_with_latents(plain, v)
    out_b, lat_b = forward_with_latents(remat, v)
    out_b.sum().backward()
    assert torch.equal(out_a, out_b)
    for k in lat_a:
        assert torch.equal(lat_a[k], lat_b[k])


def test_sfno_finetune_example_end_to_end(tmp_path):
    """The fine-tune example at 64² (the trained modes 32 fill the mesh),
    fp64, on a toy checkpoint and a test file of solver trajectories (frames
    t_start..t_start+19)."""
    from tpu_cfd_torch.examples import ex2_sfno_finetune as ex

    n = 64
    out = tt.get_trajectory_imex_crank_nicolson(
        _t(_smooth_field(n, b=2, seed=10)), torch.zeros(n, n, dtype=torch.float64),
        visc=1e-3, T=0.024, delta_t=1e-3, record_steps=24)
    path = tmp_path / "test.npz"
    np.savez(path, vorticity=out["vorticity"].numpy())
    model = SFNO(modes_x=32, modes_y=32, modes_t=5, width=10, beta=-1e-2, output_steps=10)
    ckpt = pipeline.save_checkpoint(model, tmp_path / "sfno")[:-3]
    result = ex.main(["--example", "McWilliams2d", "--res", str(n), "--modes-ft", "32",
                      "32", "6", "--t-start", "2", "--ckpt", ckpt, "--test-file",
                      str(path), "--iters", "3", "--gt-floor", "--lr-decay", "0.05",
                      "--no-cuda"])
    hist = result["history"]
    assert len(hist) == 4 and len(result["iter_seconds"]) == 3
    assert all(np.isfinite([h[k] for h in hist for k in h]))
    assert result["best"] == min(h["residual"] for h in hist)
    assert result["best"] <= hist[0]["residual"]
    assert np.isfinite(result["gt_floor"]) and np.isfinite(result["zero_shot_rel_l2"])


def test_train_and_finetune_example_end_to_end(tmp_path, monkeypatch):
    """The demo's three stages at 64² → 32² with 40 steps of generation."""
    from tpu_cfd_torch.examples import ex2_train_and_finetune as ex

    monkeypatch.setattr(ex, "GENERATE", [
        "--grid-size", "64", "--subsample", "2", "--num-samples", "8",
        "--batch-size", "4", "--time", "0.05", "--time-warmup", "0.01",
        "--dt", "1e-3", "--num-steps", "24"])
    monkeypatch.setattr(ex, "FT_MODES", (12, 12, 4))
    monkeypatch.setattr(ex, "FT_STEPS", 3)
    result = ex.main(["--workdir", str(tmp_path), "--no-cuda"])
    assert result["train_steps"] == 15 and len(result["train_history"]) == 5
    assert len(result["finetune_history"]) == 4
    assert np.isfinite(result["train_history"] + result["finetune_history"]).all()


def test_recipe_accuracy_fine_tune_data_runs_the_jax_logs_arguments():
    """The fine-tune stage's fp64 test set takes the arguments of the JAX run
    it is compared with (``logs/datagen_fp64_mc_r4.log``, line 1)."""
    import ast
    import pathlib

    from tpu_cfd_torch.data import data_utils
    from tpu_cfd_torch.train import recipe_accuracy

    root = pathlib.Path(__file__).resolve().parents[1]
    first = (root / "logs" / "datagen_fp64_mc_r4.log").read_text().splitlines()[0]
    logged = dict(item.split("=", 1) for item in first.split(" - INFO - ", 1)[1].split(" | "))
    ours = vars(data_utils.get_args_ns2d().parse_args(recipe_accuracy.FT_DATA))
    # set by the mcwilliams CLI itself (diam, forcing) or naming outputs
    skip = {"diam", "forcing", "filepath", "logpath", "filename", "example"}
    compared = [k for k in logged if k in ours and k not in skip]
    assert len(compared) >= 30

    def literal(text):
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return text

    differ = {k: (ours[k], logged[k]) for k in compared if ours[k] != literal(logged[k])}
    assert not differ, f"recipe_accuracy.FT_DATA differs from the JAX log: {differ}"
    assert recipe_accuracy.FINETUNE == ["--example", "McWilliams2d", "--gt-floor",
                                        "--lr-decay", "0.05", "--iters", "160"]
