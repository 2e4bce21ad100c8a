"""The port's fused pointwise FFN (ops/cuda/ffn.py) vs the JAX Pallas kernel.

On the CPU the kernel runs its plain PyTorch version; it is held against
``tpu_cfd.ops.pallas.ffn.fused_pointwise_ffn`` in interpret mode (as
tests/test_pallas.py runs it) for every activation of ``get_activation``,
with a row count that the Pallas block does not divide: values to 1e-5 and
gradients (input and all four weights) to 1e-4 of the largest reference
entry. With bfloat16 rows both keep float32 weights and sums and round once at
the store, so they agree to one bfloat16 spacing (2^-7) of the largest entry.
The CUDA kernel runs only on the card:
tests/test_torch_cuda_kernels.py holds it against the plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_cfd.models.base import get_activation as jax_activation
from tpu_cfd.ops.pallas import ffn as pffn
from tpu_cfd_torch.models.base import PointwiseFFN, get_activation
from tpu_cfd_torch.ops.cuda import ffn as tffn

torch.set_num_threads(2)

ACTS = sorted(tffn.ACTIVATIONS)
M_SHAPE, K, H, K_OUT = (3, 5, 5), 6, 20, 4   # 75 rows, Pallas block 32


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    # kernel layout (in, out), as flax's Dense; the port takes nn.Linear's
    return (f(*M_SHAPE, K, scale=2.0), f(K, H, scale=0.5), f(H), f(H, K_OUT, scale=0.3),
            f(K_OUT), f(*M_SHAPE, K_OUT))


def test_activations_match_flax():
    x = np.linspace(-30, 30, 601).astype(np.float32)
    for name in ACTS:
        want = np.asarray(jax_activation(name)(jnp.asarray(x)))
        got = get_activation(name)(torch.from_numpy(x)).numpy()
        assert _rel_err(got, want) < 1e-6, name


@pytest.mark.parametrize("act", ACTS)
def test_ffn_matches_jax_pallas(act):
    x, w1, b1, w2, b2, r = _inputs()

    def loss(*args):
        out = pffn.fused_pointwise_ffn(*args, jax_activation(act), 32)
        return (out * r).sum(), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(x, w1, b1, w2, b2)

    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for a in (x, w1.T, b1, w2.T, b2)]
    out_t = tffn.pointwise_ffn(*ts, act)
    (out_t * torch.from_numpy(r)).sum().backward()

    assert _rel_err(out_t.detach(), out_j) < 1e-5
    for name, t, g, transpose in zip(("x", "w1", "b1", "w2", "b2"), ts, grads_j,
                                     (False, True, False, True, False)):
        got = t.grad.numpy().T if transpose else t.grad.numpy()
        assert _rel_err(got, g) < 1e-4, name


@pytest.mark.parametrize("act", ["ReLU", "GELU"])
def test_bf16_rows_match_jax_pallas(act):
    x, w1, b1, w2, b2, r = _inputs()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out_j = pffn.fused_pointwise_ffn(xb, w1, b1, w2, b2, jax_activation(act), 32)
    assert out_j.dtype == jnp.bfloat16
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    assert np.array_equal(tx.detach().float().numpy(), np.asarray(xb.astype(jnp.float32)))
    ws = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
          for a in (w1.T, b1, w2.T, b2)]
    out_t = tffn.pointwise_ffn(tx, *ws, act)
    assert out_t.dtype == torch.bfloat16
    want = np.asarray(out_j.astype(jnp.float32))
    assert _rel_err(out_t.detach().float().numpy(), want) <= 2.0 ** -7
    # gradients come back in the types of their inputs
    (out_t.float() * torch.from_numpy(r)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert all(w.grad.dtype == torch.float32 for w in ws)
    # and equal the float32 FFN's on the same (bf16-valued) rows and
    # cotangent, up to the rounding of the input gradient
    x32 = tx.detach().float().requires_grad_(True)
    ws32 = [w.detach().clone().requires_grad_(True) for w in ws]
    r16 = torch.from_numpy(r).bfloat16().float()
    (tffn.pointwise_ffn(x32, *ws32, act) * r16).sum().backward()
    assert _rel_err(tx.grad.float(), x32.grad) <= 2.0 ** -7
    for w, w32 in zip(ws, ws32):
        assert _rel_err(w.grad, w32.grad) < 1e-5


def test_module_takes_the_kernel_route_in_fp32_only():
    ffn = PointwiseFFN(K, K_OUT, H, "GELU")
    x = torch.from_numpy(_inputs()[0])
    want = ffn.dense_1(get_activation("GELU")(ffn.dense_0(x)))
    got = ffn(x)
    assert got.grad_fn.name().endswith("_PointwiseFFNBackward")
    assert _rel_err(got.detach(), want.detach()) < 1e-6
    # bfloat16 rows take it too (float32 weights and sums), float64 does not
    got16 = ffn(x.bfloat16())
    assert got16.dtype == torch.bfloat16
    assert got16.grad_fn.name().endswith("_PointwiseFFNBackward")
    cast = PointwiseFFN(K, K_OUT, H, "GELU", dtype=torch.bfloat16)
    cast.load_state_dict(ffn.state_dict())
    assert torch.equal(cast(x), got16)
    got64 = ffn.double()(x.double())
    assert not got64.grad_fn.name().endswith("_PointwiseFFNBackward")


def test_non_cpu_tensors_never_fall_back():
    x, w1, b1, w2, b2, _ = (torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs())
    x2 = x.reshape(-1, K)
    with pytest.raises(ValueError, match="no FFN kernel"):
        tffn.ffn_forward(x2.to("meta"), w1.T, b1, w2.T, b2, "ReLU")
    with pytest.raises(ValueError, match="unsupported activation"):
        tffn.pointwise_ffn(x, w1.T, b1, w2.T, b2, "Swish")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tffn._launch_ffn(x2, w1.T.contiguous(), b1, w2.T.contiguous(), b2, "ReLU")


def test_flops_at_the_recipe():
    # 64 x 64^2 x 10 rows, K = K_out = 10, H = 40: the count the bound in
    # chip_smoke.py uses
    assert tffn.flops(2_621_440, 10, 40, 10) == 4_194_304_000


def test_launch_checks_its_inputs_before_the_kernel():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="float32"):
        tffn._launch_ffn(x, torch.zeros(8, 6, dtype=torch.float64), torch.zeros(8),
                         torch.zeros(6, 8), torch.zeros(6), "ReLU")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tffn._launch_ffn(x.half(), torch.zeros(8, 6), torch.zeros(8),
                         torch.zeros(6, 8), torch.zeros(6), "ReLU")
    with pytest.raises(ValueError, match="w1 must be float32"):  # weights stay fp32
        tffn._launch_ffn(x.bfloat16(), torch.zeros(8, 6).bfloat16(), torch.zeros(8),
                         torch.zeros(6, 8), torch.zeros(6), "ReLU")
    with pytest.raises(ValueError, match="contiguous"):
        tffn._launch_ffn(x, torch.zeros(6, 8).t(), torch.zeros(8),
                         torch.zeros(6, 8), torch.zeros(6), "ReLU")
