"""Fused pointwise FFN ``act(x @ w1 + b1) @ w2 + b2``: CUDA kernel and wrapper.

Replaces the TPU kernel ``tpu_cfd/ops/pallas/ffn.py::_ffn_kernel`` (its
``pallas_call`` in ``_ffn_forward``). ``csrc/ffn.cu`` runs both products on
the tensor cores (``mma.sync`` TF32 with the 3xTF32 split, fp32-accurate),
16 rows a warp, with both weight matrices split into TF32 parts in shared
memory and the hidden activations in registers, so x is read once and the
output written once (see its header for the bound and the design);
``ffn_layout`` is its shared-memory layout.

``pointwise_ffn`` is a ``torch.autograd.Function``: its forward is the
kernel on a CUDA tensor and the plain PyTorch version (``_ffn_plain``) on a
CPU tensor; its backward is plain PyTorch matmuls on both, as the JAX
kernel's VJP (``_ffn_bwd``) is plain XLA. Weights use ``nn.Linear``'s
layout: w1 ``(H, K)``, w2 ``(K_out, H)``.

The rows of x are float32 or bfloat16 and the output has their type; the
weights are float32 and every sum is float32, rounded once at the store (the
TPU kernel's ``preferred_element_type=float32`` and ``astype(o_ref.dtype)``).
The backward computes in float32 and returns each gradient in the type of
its input.

``ACTIVATIONS`` lists every activation the SFNO takes by the reference's
names, in the order of the kernel's enum. GELU is the tanh approximation,
as flax's ``nn.gelu`` is by default.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

ACTIVATIONS = {
    "ReLU": torch.relu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "SiLU": F.silu,
    "ELU": F.elu,
    "CELU": F.celu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "SoftPlus": F.softplus,
    "Mish": F.mish,
    "Identity": lambda x: x,
}
_ACT_CODE = {name: i for i, name in enumerate(ACTIVATIONS)}

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"ffn": 0}

ROW_DTYPES = (torch.float32, torch.bfloat16)

_CUDA_ERROR_INVALID_VALUE = 1  # csrc/ffn.cu's answer to a size it does not take
SMEM_LIMIT = 232448  # bytes of shared memory a block may have (227 KB)
MAX_WIDTH = 64       # K and K_out the kernel takes


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ffn_plain(x2: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
               act: str) -> Tensor:
    """(M, K) rows -> (M, K_out): the kernel's arithmetic in plain PyTorch.

    bfloat16 rows go up to float32, as the weights are, and the result is
    rounded back once."""
    xf = x2.float() if x2.dtype == torch.bfloat16 else x2
    return F.linear(ACTIVATIONS[act](F.linear(xf, w1, b1)), w2, b2).to(x2.dtype)


@functools.lru_cache(maxsize=None)
def ffn_layout(k: int, h: int, k_out: int, row_bytes: int):
    """The kernel's shared-memory layout for this shape, as ``(15 ints in the
    order of csrc/ffn.cu's FfnLayout, bytes)``, or ``None`` where it takes no
    launch: K or K_out above ``MAX_WIDTH``, or weights too large for a block.

    K, K_out and H are padded to multiples of 8 (``ks``, ``ns``, ``hs``
    steps of 8). Shared memory holds W1 and W2 as the TF32 hi and lo parts of
    each lane's B fragments (a float4 per lane and product step: ``hs * ks``
    and ``hs * ns`` steps of 512 bytes), the zero-padded biases, and per warp
    two 16-row tiles of x and one of the output, in the rows' own type
    (``row_bytes`` an element). A block has 8 warps, or 4, 2 or 1 where 8
    do not fit; ``p`` is the template instance, 8 times the larger of ``ks``
    and ``ns``.
    """
    if not (0 < k <= MAX_WIDTH and 0 < k_out <= MAX_WIDTH and h > 0):
        return None
    ks, ns, hs = -(-k // 8), -(-k_out // 8), -(-h // 8)
    w2f = 512 * hs * ks
    b1 = w2f + 512 * hs * ns
    b2 = b1 + 32 * hs
    xs = b2 + 32 * ns
    xbuf, obuf = 16 * k * row_bytes, 16 * k_out * row_bytes
    for warps in (8, 4, 2, 1):
        nbytes = xs + warps * (2 * xbuf + obuf)
        if nbytes <= SMEM_LIMIT:
            ints = (k, h, k_out, ks, ns, hs, warps, 0, w2f, b1, b2, xs, xbuf, obuf,
                    8 * max(ks, ns))
            return ints, nbytes
    return None


@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("ffn")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pointwise_ffn.argtypes = [P] * 6 + [L, I, I, P, I, P]
    lib.pointwise_ffn.restype = I
    return lib


def _launch_ffn(x2: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                act: str) -> Tensor:
    m, k = x2.shape
    h, k_out = w1.shape[0], w2.shape[0]
    if x2.dtype not in ROW_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x2.dtype}")
    for name, t, shape in (("x", x2, (m, k)), ("w1", w1, (h, k)), ("b1", b1, (h,)),
                           ("w2", w2, (k_out, h)), ("b2", b2, (k_out,))):
        if t.device != x2.device or (t is not x2 and t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {x2.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    layout = ffn_layout(k, h, k_out, x2.element_size())
    if layout is None:
        raise RuntimeError(
            f"pointwise_ffn does not take K={k}, H={h}, K_out={k_out}: K and K_out "
            f"at most {MAX_WIDTH}, and both weight matrices in one block's shared memory")
    ints, nbytes = layout
    out = torch.empty((m, k_out), dtype=x2.dtype, device=x2.device)
    if m == 0:  # csrc/ffn.cu launches nothing for no rows
        return out
    if x2.data_ptr() % 16:  # the row tiles come in as 16-byte copies
        x2 = x2.clone()
    lib = _lib()  # built at first use
    # a launch goes to the host thread's current device: make it x2's
    with torch.cuda.device(x2.device):
        err = lib.pointwise_ffn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), m, _ACT_CODE[act],
            int(x2.dtype == torch.bfloat16), (ctypes.c_int * len(ints))(*ints), nbytes,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise RuntimeError(
            f"pointwise_ffn does not take K={k}, H={h}, K_out={k_out}: no block "
            "of its shared memory fits on an SM")
    if err != 0:
        raise RuntimeError(f"CUDA kernel pointwise_ffn failed with cudaError {err}")
    LAUNCHES["ffn"] += 1
    return out


def ffn_forward(x2: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                act: str) -> Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return _ffn_plain(x2, w1, b1, w2, b2, act)
    if x2.device.type == "cuda":
        return _launch_ffn(x2, w1, b1, w2, b2, act)
    raise ValueError(f"no FFN kernel for device {x2.device}")


class _PointwiseFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        out = ffn_forward(x2, w1, b1, w2, b2, act)
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.act, ctx.shape = act, x.shape
        return out.reshape(*x.shape[:-1], w2.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2 = ctx.saved_tensors
        rows = x2.dtype
        x2 = x2.to(w1.dtype)
        g2 = g.reshape(-1, g.shape[-1]).to(w1.dtype)
        with torch.enable_grad():
            pre = F.linear(x2, w1, b1).detach().requires_grad_()
            h = ACTIVATIONS[ctx.act](pre)
        (gpre,) = torch.autograd.grad(h, pre, g2 @ w2)
        gx = (gpre @ w1).reshape(ctx.shape).to(rows)
        return (gx, gpre.t() @ x2, gpre.sum(0), g2.t() @ h.detach(), g2.sum(0),
                None)


def pointwise_ffn(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                  act: str = "ReLU") -> Tensor:
    """``act(x @ w1.T + b1) @ w2.T + b2`` over the last axis of x.

    x float32 or bfloat16 (the output's type), weights float32.
    Forward through ``ffn_forward`` (the kernel on CUDA tensors); backward
    in plain PyTorch.
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act!r}; available: "
                         f"{sorted(ACTIVATIONS)}")
    return _PointwiseFFN.apply(x, w1, b1, w2, b2, act)


def flops(m: int, k: int, h: int, k_out: int) -> int:
    """Multiply-adds of both products, two flops each (activation not counted)."""
    return 2 * m * h * (k + k_out)
