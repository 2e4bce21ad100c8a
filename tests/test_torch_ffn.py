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


# -- the tensor-core kernel's arithmetic, emulated (csrc/ffn.cu) -------------
# mma.sync.m16n8k8 fragments, lane = 4 g + t (csrc/tf32_mma.cuh): A (16 x 8)
# a[q] = A[g + 8 (q & 1)][t + 4 (q >> 1)], B (8 x 8) b[q] = B[t + 4 q][g],
# C (16 x 8) c[q] = C[g + 8 (q >> 1)][2 t + (q & 1)].
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
_Q4 = np.arange(4)
_A_ROW, _A_COL = _G[:, None] + 8 * (_Q4 & 1), _T[:, None] + 4 * (_Q4 >> 1)
_B_ROW, _B_COL = _T[:, None] + 4 * np.arange(2), np.broadcast_to(_G[:, None], (32, 2))
_C_ROW, _C_COL = _G[:, None] + 8 * (_Q4 >> 1), 2 * _T[:, None] + (_Q4 & 1)


def _tf32(a):
    """float32 -> float32 rounded to TF32 as cvt.rna.tf32.f32 does, and as
    csrc/ffn.cu does with integer ops: to the nearest 10-bit mantissa, ties
    away from zero."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _read_tf32(a):
    """A float32 register as the tensor core reads a TF32 operand: its top 19
    bits, the rest dropped (truncation toward zero)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """csrc/ffn.cu's split: hi rounded to TF32, lo = a - hi (exact) as it is,
    which the tensor core reads truncated."""
    hi = _tf32(a)
    return hi, _read_tf32(np.asarray(a, np.float32) - hi)


def _mma(c, a, b):
    """c (T, 32, 4) += A @ B from the fragments a (T, 32, 4), b (32, 2), in
    float64: the TF32 products are exact and the sum is fp32 on the card."""
    A = np.zeros(a.shape[:-2] + (16, 8))
    A[..., _A_ROW, _A_COL] = a
    B = np.zeros((8, 8))
    B[_B_ROW, _B_COL] = b
    C = np.zeros(c.shape[:-2] + (16, 8))
    C[..., _C_ROW, _C_COL] = c
    return (C + A @ B)[..., _C_ROW, _C_COL]


def _gelu_sigmoid(x):
    """csrc/ffn.cu's GELU: x sigma(2u) = x / (1 + exp(-2u)), in float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(over="ignore"):
        e = np.exp(np.float32(-1.5957691216057308) * (np.float32(0.044715) * x * x * x + x))
    return x / (np.float32(1) + e)


_EMU_ACTS = {"GELU": _gelu_sigmoid, "ReLU": lambda x: np.maximum(x, np.float32(0))}


def _emulate_ffn(x, w1, b1, w2, b2, act, bf16_rows=False, passes=3, permute=True):
    """csrc/ffn.cu's forward on (M, K) float32 rows, step by step: W1 and W2
    staged as each lane's hi/lo B fragments (W2's hidden units in the order
    [0, 2, 4, 6, 1, 3, 5, 7] within each block of 8 unless ``permute`` is
    off), 16-row tiles, the first product's accumulators activated and split
    into the second product's A fragments in registers. ``passes`` 1 keeps
    only hi x hi (plain TF32)."""
    m, k = x.shape
    h, k_out = w1.shape[0], w2.shape[0]
    ks, ns, hs = -(-k // 8), -(-k_out // 8), -(-h // 8)
    pad = lambda a, shape: np.pad(a, [(0, s - d) for s, d in zip(shape, a.shape)])  # noqa: E731
    W1 = pad(w1, (8 * hs, 8 * ks))
    W2 = pad(w2, (8 * ns, 8 * hs))
    B1, B2 = pad(b1, (8 * hs,)), pad(b2, (8 * ns,))
    tiles = -(-m // 16)
    X = pad(x, (16 * tiles, 8 * ks)).reshape(tiles, 16, 8 * ks)
    # W1 fragments: b0 = w1[8j+g][8ks+t], b1 = w1[8j+g][8ks+t+4]
    w1f = [[_split(W1[8 * j + _B_COL, 8 * s + _B_ROW]) for s in range(ks)]
           for j in range(hs)]
    # W2 fragments: b0 = w2[8ns+g][8j+2t], b1 = w2[8ns+g][8j+2t+1] (permuted),
    # or w2[8ns+g][8j+t], w2[8ns+g][8j+t+4] (the plain order)
    hid = 2 * _T[:, None] + np.arange(2) if permute else _B_ROW
    w2f = [[_split(W2[8 * o + _B_COL, 8 * j + hid]) for o in range(ns)] for j in range(hs)]
    xa = [_split(X[:, _A_ROW, 8 * s + _A_COL]) for s in range(ks)]
    if bf16_rows:  # bf16 values are exact in TF32: no lo part, two passes
        assert all(not lo.any() for _, lo in xa)

    def product(c, a, b):
        (ah, al), (bh, bl) = a, b
        terms = [(al, bh), (ah, bl), (ah, bh)][3 - passes:]
        for p, q in terms:
            c = _mma(c, p, q)
        return c

    acc = [np.broadcast_to(B2[8 * o + _C_COL], (tiles, 32, 4)).astype(np.float64)
           for o in range(ns)]
    for j in range(hs):
        pre = np.broadcast_to(B1[8 * j + _C_COL], (tiles, 32, 4)).astype(np.float64)
        for s in range(ks):
            pre = product(pre, xa[s], w1f[j][s])
        hv = _EMU_ACTS[act](pre.astype(np.float32))
        a2 = _split(hv[..., [0, 2, 1, 3]])   # C fragment -> A fragment
        for o in range(ns):
            acc[o] = product(acc[o], a2, w2f[j][o])
    out = np.zeros((tiles, 16, 8 * ns))
    for o in range(ns):
        out[..., _C_ROW, 8 * o + _C_COL] = acc[o]
    return out.reshape(16 * tiles, 8 * ns)[:m, :k_out]


def _ffn_case(k, h, k_out, m, seed=0, bf16_rows=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, a=1.0: (a * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    x = f(m, k, a=2.0)
    if bf16_rows:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x, f(h, k, a=0.5), f(h, a=0.1), f(k_out, h, a=0.3), f(k_out, a=0.1)


def _plain64(x, w1, b1, w2, b2, act):
    t = [torch.from_numpy(a).double() for a in (x, w1, b1, w2, b2)]
    return tffn._ffn_plain(*t, act).numpy()


# the recipe's and the sweep's instances, K and K_out not multiples of 8, H
# not a multiple of 8, a ragged last tile
EMU_CASES = [(10, 40, 10, "GELU"), (20, 80, 20, "ReLU"), (12, 37, 5, "GELU"),
             (4, 20, 9, "ReLU")]


@pytest.mark.parametrize("bf16_rows", [False, True])
@pytest.mark.parametrize("k,h,k_out,act", EMU_CASES)
def test_tensor_core_arithmetic_matches_plain(k, h, k_out, act, bf16_rows):
    """The emulated kernel within chip_smoke.py's KERNEL_TOL (1e-5 of the
    largest entry) of the plain version in float64; plain TF32 (one pass) and
    W2 staged without the permutation both miss it, so the gate sees each."""
    args = _ffn_case(k, h, k_out, 83, bf16_rows=bf16_rows)
    want = _plain64(*args, act)
    scale = np.abs(want).max()
    got = _emulate_ffn(*args, act, bf16_rows=bf16_rows)
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(_emulate_ffn(*args, act, passes=1) - want).max() > 1e-5 * scale
    assert np.abs(_emulate_ffn(*args, act, permute=False) - want).max() > 1e-2 * scale


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)   # TF32 spacing at 1
    got = _tf32(np.array([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                          1 + 3 * 2.0 ** -12, 2.0 ** -12], np.float32))
    assert got.tolist() == [one + ulp, one, -(one + ulp), one + ulp, 2.0 ** -12]
    (hi,), (lo,) = _split(np.float32([1 / 3]))
    assert hi != np.float32(1 / 3) and abs(float(hi) + float(lo) - 1 / 3) < 2.0 ** -21


def test_gelu_as_x_sigmoid_2u_matches_flax():
    """x sigma(2u) equals flax's 0.5 x (1 + tanh u) to float32 rounding, and
    keeps both limits: 0 for large negative x (exp overflows), x for large
    positive x."""
    x = np.concatenate([np.linspace(-30, 30, 6001), [-1e4, -500, -89, 89, 500, 1e4]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = _gelu_sigmoid(x)
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= 2e-6 * np.maximum(np.abs(x), 1))
    assert np.all(got[x < -20] <= 0) and np.all(got[x < -20] > -1e-30)
    assert np.array_equal(got[x > 20], x[x > 20])


@pytest.mark.parametrize("k,h,k_out,row_bytes,want", [
    # the recipe (fp32 rows): 10 KB of weight fragments, 8 warps
    ((10, 40, 10, 4, dict(ks=2, ns=2, hs=5, warps=8, p=16, nbytes=25_824))),
    # the sweep (bf16 rows): 30 KB of weight fragments
    ((20, 80, 20, 2, dict(ks=3, ns=3, hs=10, warps=8, p=24, nbytes=46_496))),
    # H not a multiple of 8, K and K_out apart: the larger sets the instance
    ((4, 37, 20, 4, dict(ks=1, ns=3, hs=5, warps=8, p=24, nbytes=24_832))),
    # the widest rows: fewer warps where 8 do not fit
    ((64, 200, 64, 4, dict(ks=8, ns=8, hs=25, warps=2, p=64, nbytes=230_432))),
])
def test_ffn_layout_by_shape(k, h, k_out, row_bytes, want):
    ints, nbytes = tffn.ffn_layout(k, h, k_out, row_bytes)
    names = ("K", "H", "KO", "ks", "ns", "hs", "warps", "w1f", "w2f", "b1", "b2",
             "xs", "xbuf", "obuf", "p")
    got = dict(zip(names, ints), nbytes=nbytes)
    assert {key: got[key] for key in want} == want
    assert (got["K"], got["H"], got["KO"]) == (k, h, k_out)
    # regions in order, each 16-byte aligned, within a block's shared memory
    assert got["w1f"] == 0 and got["w2f"] == 512 * got["hs"] * got["ks"]
    assert got["b1"] == got["w2f"] + 512 * got["hs"] * got["ns"]
    assert got["xs"] == got["b1"] + 32 * got["hs"] + 32 * got["ns"]
    assert all(got[key] % 16 == 0 for key in ("w2f", "b1", "b2", "xs", "xbuf", "obuf"))
    assert (got["xbuf"], got["obuf"]) == (16 * k * row_bytes, 16 * k_out * row_bytes)
    assert nbytes == got["xs"] + got["warps"] * (2 * got["xbuf"] + got["obuf"])
    assert nbytes <= tffn.SMEM_LIMIT


def test_ffn_layout_refuses_what_the_kernel_does_not_take():
    assert tffn.ffn_layout(65, 40, 10, 4) is None          # K above 64
    assert tffn.ffn_layout(10, 40, 65, 4) is None          # K_out above 64
    assert tffn.ffn_layout(64, 256, 64, 4) is None         # weights too large
    assert tffn.ffn_layout(64, 256, 64, 2) is None
    x = torch.zeros(3, 65)
    with pytest.raises(RuntimeError, match="does not take K=65"):
        tffn._launch_ffn(x, torch.zeros(8, 65), torch.zeros(8), torch.zeros(4, 8),
                         torch.zeros(4), "ReLU")
