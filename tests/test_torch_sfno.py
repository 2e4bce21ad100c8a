"""The port's SFNO modules (models/sfno.py) vs the JAX package's, and convert.py.

Every module of ``sfno.py`` and the whole SFNO (16², width 4, modes 4/4/3,
3 layers, b=2) run on the same numpy inputs with the same flax parameters,
carried across by ``tpu_cfd_torch.convert`` (perturbed from flax's init so
that no bias or scale sits at its trivial value). Forward to 1e-5 of the
largest reference entry; for the whole SFNO, per-leaf gradients to 1e-4 of
the leaf's largest entry. On the CPU the port's SpectralConvS runs the DFT
kernels' plain versions and the JAX one its einsum path.
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
def _sfno_params(out_dim: int):
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=W, num_spectral_layers=3,
              activation="GELU", beta=0.0, out_dim=out_dim)
    jmod, v = jm.SFNO(**kw), _field(B, N, N, NT)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), v)
    return kw, jmod, _perturbed(params, 0), v


def _sfno_pair(out_dim=1):
    kw, jmod, params, v = _sfno_params(out_dim)
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
