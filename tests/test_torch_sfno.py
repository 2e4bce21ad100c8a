"""The port's SFNO modules (models/sfno.py) vs the JAX package's, and convert.py.

Every module of ``sfno.py`` and the whole SFNO (16², width 4, modes 4/4/3,
3 layers, b=2) run on the same numpy inputs with the same flax parameters,
carried across by ``tpu_cfd_torch.convert`` (perturbed from flax's init so
that no bias or scale sits at its trivial value). Forward to 1e-5 of the
largest reference entry; for the whole SFNO, per-leaf gradients to 1e-4 of
the leaf's largest entry. On the CPU the port's SpectralConvS runs the DFT
kernels' plain versions and the JAX one its einsum path. With
``compute_dtype="bfloat16"`` the two frameworks round at other places, so the
outputs are held to the rel-L2 0.05 of ``tests/test_models.py``; with
``remat`` the port equals itself without it exactly and flax to 1e-5 / 1e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_cfd import models as jm
from tpu_cfd_torch import convert
from tpu_cfd_torch import models as tm
from tpu_cfd_torch.models.base import init_like_flax

torch.set_num_threads(2)

B, N, NT, W, MODES = 2, 16, 10, 4, (4, 4, 3)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def f(p):
        p = np.asarray(p)
        scale = 0.1 * max(float(np.abs(p).max()), 0.1)
        return (p + scale * rng.standard_normal(p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(f, jax.device_get(params))


def _pair(jmod, tmod, kind, args, seed=0, **call):
    """Init the flax module, perturb, convert into the torch module."""
    init = jax.jit(functools.partial(jmod.init, **call))
    params = _perturbed(init(jax.random.PRNGKey(seed), *args), seed)
    tmod.load_state_dict(convert.state_dict_from_flax(kind, params))
    return params


def _apply(jmod, params, *args, **call):
    """The flax module's output as numpy (jitted: eager flax is slow)."""
    return np.asarray(jax.jit(functools.partial(jmod.apply, **call))(params, *args))


def _field(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("random_feats", [False, True])
def test_positional_encoding(random_feats):
    kw = dict(modes_x=2, modes_y=2, modes_t=2, num_channels=W,
              spatial_random_feats=random_feats, time_exponential_scale=0.1)
    jmod, tmod = jm.SpaceTimePositionalEncoding(**kw), tm.SpaceTimePositionalEncoding(**kw)
    v = _field(B, N, N, NT, 1)
    params = _pair(jmod, tmod, "SpaceTimePositionalEncoding", (v,))
    assert _rel_err(tmod(_t(v)).detach(), _apply(jmod, params, v)) < 1e-5


def test_helmholtz_projection():
    rng = np.random.default_rng(0)
    u = (rng.standard_normal((B, N, N, 4, 2))
         + 1j * rng.standard_normal((B, N, N, 4, 2))).astype(np.complex64)
    got = tm.HelmholtzProjection(diam=1.0)(_t(u))
    want = _apply(jm.HelmholtzProjection(diam=1.0), {}, u)
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_spectral_conv_s(impl):
    jmod = jm.SpectralConvS(in_channels=W, out_channels=3, modes=MODES, impl=impl)
    tmod = tm.SpectralConvS(W, 3, MODES, impl=impl)
    v = _field(B, N, N, NT, W)
    params = _pair(jmod, tmod, "SpectralConv", (v,))
    assert _rel_err(tmod(_t(v)).detach(), _apply(jmod, params, v)) < 1e-5


@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("helmholtz", [False, True])
def test_spectral_conv_t(impl, helmholtz):
    """Temporal padding, resampled output steps, Helmholtz postprocess."""
    d = 2 if helmholtz else W
    kw = dict(modes=MODES, bias=True, delta=0.1, impl=impl)
    jmod = jm.SpectralConvT(in_channels=d, out_channels=d, temporal_padding=True,
                            postprocess=jm.HelmholtzProjection(diam=1.0)
                            if helmholtz else None, **kw)
    tmod = tm.SpectralConvT(d, d, temporal_padding=True,
                            postprocess=tm.HelmholtzProjection(diam=1.0)
                            if helmholtz else None, **kw)
    v = _field(B, N, N, 7, d)
    params = _pair(jmod, tmod, "SpectralConv", (v,), out_steps=12)
    got = tmod(_t(v), out_steps=12)
    assert _rel_err(got.detach(), _apply(jmod, params, v, out_steps=12)) < 1e-5


@pytest.mark.parametrize("nonlinear", [True, False])
def test_lifting_operator(nonlinear):
    kw = dict(width=W, modes_x=4, modes_y=4, modes_t=3, latent_steps=8,
              activation="GELU", beta=0.1, nonlinear=nonlinear)
    jmod, tmod = jm.LiftingOperator(**kw), tm.LiftingOperator(**kw)
    v = _field(B, N, N, NT, 1)
    params = _pair(jmod, tmod, "LiftingOperator", (v,))
    assert _rel_err(tmod(_t(v)).detach(), _apply(jmod, params, v)) < 1e-5


@pytest.mark.parametrize("out_dim", [1, 2])
def test_out_conv(out_dim):
    kw = dict(modes_x=4, modes_y=4, modes_t=3, out_dim=out_dim)
    jmod, tmod = jm.OutConv(**kw), tm.OutConv(**kw)
    v, v_res = _field(B, N, N, 8, out_dim), _field(B, N, N, NT, seed=2)
    params = _pair(jmod, tmod, "OutConv", (v, v_res), out_steps=NT)
    got = tmod(_t(v), _t(v_res), out_steps=NT)
    assert _rel_err(got.detach(), _apply(jmod, params, v, v_res, out_steps=NT)) < 1e-5


@functools.lru_cache(maxsize=None)
def _sfno_params(out_dim: int, **extra):
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=W, num_spectral_layers=3,
              activation="GELU", beta=0.0, out_dim=out_dim, **extra)
    jmod, v = jm.SFNO(**kw), _field(B, N, N, NT)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), v)
    return kw, jmod, _perturbed(params, 0), v


def _sfno_pair(out_dim=1, **extra):
    kw, jmod, params, v = _sfno_params(out_dim, **extra)
    tmod = tm.SFNO(**kw)
    tmod.load_state_dict(convert.sfno_state_dict_from_flax(params))
    return jmod, tmod, params, v


@pytest.mark.parametrize("out_dim", [1, 2])
def test_sfno_forward_and_grads(out_dim):
    jmod, tmod, params, v = _sfno_pair(out_dim)
    r = _field(*((B, N, N, NT) + ((2,) if out_dim == 2 else ())), seed=5)

    def loss(p):
        out = jmod.apply(p, v)
        return (out * r).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out_t = tmod(_t(v))
    (out_t * _t(r)).sum().backward()
    assert out_t.shape == out_j.shape
    assert _rel_err(out_t.detach(), out_j) < 1e-5

    g_j = convert.state_dict_from_flax("SFNO", jax.device_get(g_j))
    for name, p in tmod.named_parameters():
        assert _rel_err(p.grad, g_j[name]) < 1e-4, name


def _count_dft_launches(monkeypatch):
    """Counts the DFT pair's forward transforms (modes) as they run."""
    from tpu_cfd_torch.ops.cuda import spectral_conv as sc

    counts = {"modes": 0}

    def modes(*args, _f=sc.modes):
        counts["modes"] += 1
        return _f(*args)

    monkeypatch.setattr(sc, "modes", modes)
    return counts


@pytest.mark.parametrize("out_dim", [1, 2])
def test_sfno_forward_and_grads_on_the_fft_route(out_dim, monkeypatch):
    """The same parity (forward 1e-5, gradients 1e-4) where ``fused_pair_wins``
    sends every SpectralConvS through the ``impl="fft"`` arithmetic."""
    from tpu_cfd_torch.models import sfno as tsfno

    monkeypatch.setattr(tsfno, "fused_pair_wins", lambda *shape: False)
    counts = _count_dft_launches(monkeypatch)
    jmod, tmod, params, v = _sfno_pair(out_dim)
    r = _field(*((B, N, N, NT) + ((2,) if out_dim == 2 else ())), seed=5)

    def loss(p):
        out = jmod.apply(p, v)
        return (out * r).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out_t = tmod(_t(v))
    (out_t * _t(r)).sum().backward()
    assert counts["modes"] == 0
    assert _rel_err(out_t.detach(), out_j) < 1e-5
    g_j = convert.state_dict_from_flax("SFNO", jax.device_get(g_j))
    for name, p in tmod.named_parameters():
        assert _rel_err(p.grad, g_j[name]) < 1e-4, name


@pytest.mark.parametrize("batch,modes,route", [
    (2, (4, 4, 3), "kernels"),     # 2m < n: the pair at every plane count
    (120, (4, 4, 3), "kernels"),
    (2, (8, 8, 3), "kernels"),     # all modes kept: the pair up to 4,525 planes
    (120, (8, 8, 3), "fft"),       # 120 x 10 x 4 = 4,800 planes
])
def test_spectral_conv_s_route_follows_the_measurement(batch, modes, route, monkeypatch):
    """On both sides of the H100 crossover the conv takes the route that
    ``fused_pair_wins`` names for its shape, and both agree with flax's
    SpectralConvS to 1e-5."""
    from tpu_cfd_torch.models.fused_conv import fused_pair_wins

    assert fused_pair_wins(N, N, modes[0], modes[1], batch * NT * W) == (route == "kernels")
    counts = _count_dft_launches(monkeypatch)
    jmod = jm.SpectralConvS(in_channels=W, out_channels=W, modes=modes, impl="dft")
    tmod = tm.SpectralConvS(W, W, modes)
    v = _field(batch, N, N, NT, W)
    params = _pair(jmod, tmod, "SpectralConv", (v,))
    got = tmod(_t(v)).detach()
    assert counts["modes"] == (route == "kernels")
    assert _rel_err(got, _apply(jmod, params, v)) < 1e-5


@pytest.mark.parametrize("batch,modes,helmholtz,route", [
    (2, (4, 4, 3), False, "dft"),    # modes a quarter of the mesh: the einsums
    (30, (4, 4, 3), False, "dft"),
    (2, (8, 8, 3), True, "dft"),     # all modes, 14 planes: the einsums
    (30, (8, 8, 3), False, "fft"),   # 30 x 7 x 4 = 840 planes: torch.fft
    (60, (8, 8, 3), True, "fft"),    # 60 x 7 x 2 = 840, Helmholtz on the fft path
])
def test_spectral_conv_t_route_follows_the_measurement(batch, modes, helmholtz, route,
                                                       monkeypatch):
    """SpectralConvT with impl="dft" takes the FFT path where
    ``dft_apply_wins`` says so for its shape, and agrees with flax's dense
    DFT route to 1e-5 on both sides (temporal padding, resampled steps)."""
    from tpu_cfd_torch.models.sfno import SpectralConvT, dft_apply_wins

    d = 2 if helmholtz else W
    assert dft_apply_wins(N, N, modes[0], modes[1], batch * 7 * d) == (route == "dft")
    taken = []
    monkeypatch.setattr(SpectralConvT, "_dft_apply", lambda self, *a, _f=SpectralConvT.
                        _dft_apply, **k: taken.append("dft") or _f(self, *a, **k))
    kw = dict(modes=modes, bias=True, delta=0.1, impl="dft")
    post = dict(j=jm.HelmholtzProjection(diam=1.0), t=tm.HelmholtzProjection(diam=1.0)
                ) if helmholtz else dict(j=None, t=None)
    jmod = jm.SpectralConvT(in_channels=d, out_channels=d, temporal_padding=True,
                            postprocess=post["j"], **kw)
    tmod = tm.SpectralConvT(d, d, temporal_padding=True, postprocess=post["t"], **kw)
    v = _field(batch, N, N, 7, d)
    params = _pair(jmod, tmod, "SpectralConv", (v,), out_steps=12)
    got = tmod(_t(v), out_steps=12)
    assert taken == (["dft"] if route == "dft" else [])
    assert _rel_err(got.detach(), _apply(jmod, params, v, out_steps=12)) < 1e-5


def test_fused_pair_wins_on_both_sides_of_the_h100_crossover():
    from tpu_cfd_torch.models.fused_conv import fused_pair_wins

    # the McWilliams recipe (64², m 32, 6,400 planes): torch.fft
    assert not fused_pair_wins(64, 64, 32, 32, 64 * 10 * 10)
    assert not fused_pair_wins(64, 64, 32, 32, 128 * 10 * 10)
    # the same at 3,200 planes and below, the optimizer sweep (m 12, 800 planes)
    # and every truncated case measured: the kernel pair
    assert fused_pair_wins(64, 64, 32, 32, 32 * 10 * 10)
    assert fused_pair_wins(64, 64, 32, 32, 4 * 10 * 20)
    assert fused_pair_wins(64, 64, 12, 12, 4 * 10 * 20)
    assert fused_pair_wins(64, 64, 24, 24, 128 * 10 * 10)
    # planes the fused kernels do not take (two passes): torch.fft
    assert not fused_pair_wins(256, 256, 32, 32, 2 * 10 * 10)


def test_dft_apply_wins_on_both_sides_of_the_h100_crossover():
    from tpu_cfd_torch.models.sfno import dft_apply_wins

    # the recipe's lifting (6,400 planes of 64²): torch.fft at m 32 and 24,
    # the einsums up to m 16
    assert not dft_apply_wins(64, 64, 32, 32, 64 * 10 * 10)
    assert not dft_apply_wins(64, 64, 24, 24, 64 * 10 * 10)
    assert dft_apply_wins(64, 64, 16, 16, 64 * 10 * 10)
    # host-bound sizes: the recipe's output conv, the sweep's two
    assert dft_apply_wins(64, 64, 32, 32, 64 * 11 * 1)
    assert dft_apply_wins(64, 64, 12, 12, 4 * 10 * 20)
    assert dft_apply_wins(64, 64, 12, 12, 4 * 11 * 1)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_sfno_remat_matches_flax_and_itself():
    jmod, tmod, params, v = _sfno_pair(remat=True)
    _, plain, _, _ = _sfno_pair()
    assert tmod.state_dict().keys() == plain.state_dict().keys()
    r = _field(B, N, N, NT, seed=5)

    def loss(p):
        out = jmod.apply(p, v)
        return (out * r).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    outs = []
    for m in (tmod, plain):
        out = m(_t(v))
        (out * _t(r)).sum().backward()
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    assert _rel_err(outs[0], out_j) < 1e-5
    g_j = convert.state_dict_from_flax("SFNO", jax.device_get(g_j))
    for (name, p), (_, q) in zip(tmod.named_parameters(), plain.named_parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert _rel_err(p.grad, g_j[name]) < 1e-4, name


def test_sfno_remat_launch_counts_double_the_wrapped_forwards(monkeypatch):
    """What chip_smoke.py expects of the launch counters under remat: each
    PointwiseFFN's forward runs twice a train step (the lifting's too, inside
    its block), each SpectralConvS's ``modes`` twice, and its ``inverse`` once:
    the recomputation stops at the block's last saved tensor, which the
    inverse transform only consumes."""
    from tpu_cfd_torch.ops.cuda import ffn as ffn_ops, spectral_conv as sc

    counts = {"modes": 0, "inverse": 0, "ffn": 0}

    def counting(name, fn):
        def wrapped(*args):
            counts[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(sc, "modes", counting("modes", sc.modes))
    monkeypatch.setattr(sc, "inverse", counting("inverse", sc.inverse))
    monkeypatch.setattr(ffn_ops, "ffn_forward", counting("ffn", ffn_ops.ffn_forward))
    want = {False: {"modes": 4, "inverse": 4, "ffn": 3},
            True: {"modes": 6, "inverse": 4, "ffn": 6}}
    for remat in (False, True):
        _, tmod, _, v = _sfno_pair(remat=remat) if remat else _sfno_pair()
        for k in counts:
            counts[k] = 0
        tmod(_t(v)).square().mean().backward()
        assert counts == want[remat], remat
        for k in counts:
            counts[k] = 0
        with torch.no_grad():
            tmod(_t(v))
        assert counts == {"modes": 2, "inverse": 2, "ffn": 3}


def test_sfno_bf16_compute_dtype_matches_flax():
    jmod, tmod, params, v = _sfno_pair(compute_dtype="bfloat16")
    _, t32, _, _ = _sfno_pair()
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    o16, o32 = tmod(_t(v)), t32(_t(v)).detach()
    assert o16.dtype == torch.float32 and o16.shape == o32.shape
    assert 0 < _rel_l2(o16.detach(), o32) < 0.05
    assert _rel_l2(o16.detach(), _apply(jmod, params, v)) < 0.05
    # the backbone really runs in bf16, and through the FFN kernel's wrapper
    seen = []
    hook = tmod.ffns[0].register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype, out.grad_fn.name())))
    tmod(_t(v)).square().mean().backward()
    hook.remove()
    assert seen[0][:2] == (torch.bfloat16, torch.bfloat16)
    assert seen[0][2].endswith("_PointwiseFFNBackward")
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tmod.parameters())
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=W, compute_dtype="int8")


def test_sfno_recipe_parameter_count():
    model = tm.SFNO(modes_x=32, modes_y=32, modes_t=5, width=10,
                    num_spectral_layers=4, activation="GELU", output_steps=10)
    assert tm.num_parameters(model) == 16_469_791


def test_init_like_flax_distributions():
    model = tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=8, num_spectral_layers=3)
    init_like_flax(model, torch.Generator().manual_seed(0))
    w = model.skips[0].weight.detach()
    std = (1 / 8) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and float(w.std()) > 0.5 * std
    assert float(model.skips[0].bias.detach().abs().max()) == 0.0
    conv = model.convs[0].weight_0.detach()
    assert 0.0 <= float(conv.min()) and float(conv.max()) < 0.5 / 64
    again = init_like_flax(tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=8,
                                   num_spectral_layers=3),
                           torch.Generator().manual_seed(0))
    assert torch.equal(again.convs[0].weight_0, conv)


def test_convert_round_trip_is_exact():
    _, tmod, params, _ = _sfno_pair()
    back = convert.sfno_flax_from_state_dict(convert.sfno_state_dict_from_flax(params))
    flat = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for k, a in flat.items():
        assert np.array_equal(np.asarray(a), flat_back[k]), k
    # from the torch side: state_dict -> flax -> state_dict
    sd = tmod.state_dict()
    again = convert.sfno_state_dict_from_flax(convert.sfno_flax_from_state_dict(sd))
    assert sd.keys() == again.keys()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_convert_rejects_unknown_and_missing_keys():
    _, _, params, _ = _sfno_pair()
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    with pytest.raises(KeyError, match="unknown"):
        convert.sfno_state_dict_from_flax({**tree, "Extra_0": {"kernel": np.zeros(1)}})
    missing = dict(tree, OutConv_0={"SpectralConvT_0": {
        k: v for k, v in tree["OutConv_0"]["SpectralConvT_0"].items() if k != "bias_2"}})
    with pytest.raises(KeyError, match="bias_2"):
        convert.sfno_state_dict_from_flax(missing)
    no_reduce = {k: v for k, v in tree.items() if k != "Dense_2"}
    with pytest.raises(KeyError, match="Dense_2"):
        convert.sfno_state_dict_from_flax(no_reduce)
    with pytest.raises(KeyError, match="unknown"):
        convert.sfno_flax_from_state_dict({**_sfno_state_dict(), "extra.weight": torch.zeros(1)})


def _sfno_state_dict():
    return tm.SFNO(modes_x=4, modes_y=4, modes_t=3, width=W,
                   num_spectral_layers=3).state_dict()
