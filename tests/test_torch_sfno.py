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
