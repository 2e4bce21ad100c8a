"""One-pass Adam update of one parameter leaf: CUDA kernel and wrapper.

Replaces the TPU kernel ``scripts/opt_layout_r4.py::fused_adam_pallas`` (its
``kernel`` body, the ``pallas_call`` in ``apply_leaf``). ``csrc/adam.cu``
reads ``p, g, m, v`` once and writes ``p, m, v`` once (see its header for the
bound); the TPU version's merged views, which exist to fill 128 lanes, have
no counterpart, since the kernel indexes a contiguous leaf linearly.

``adam_step`` updates ``p``, ``m`` and ``v`` in place (the JAX function
donates them): the kernel on CUDA tensors, the plain PyTorch version
(``_adam_plain``) on CPU tensors, an error on anything else. The bias
corrections come from the host's ``step`` count, so a step costs no
synchronisation. ``eps`` stands outside the root, as in ``optax.adam`` and
``torch.optim.Adam``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

Tensor = torch.Tensor

# Kernel launches since the last reset_launch_counts().
LAUNCHES = {"adam": 0}

BYTES_PER_ELEMENT = 7 * 4  # p, g, m, v read and p, m, v written, fp32


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bias_corrections(b1: float, b2: float, step: int):
    """``(1/(1 - b1^t), 1/(1 - b2^t))`` for the ``step``-th update, t >= 1."""
    if step < 1:
        raise ValueError(f"step counts from 1, got {step}")
    return 1.0 / (1.0 - b1 ** step), 1.0 / (1.0 - b2 ** step)


def _adam_plain(p: Tensor, g: Tensor, m: Tensor, v: Tensor, lr: float,
                b1: float, b2: float, eps: float, step: int) -> None:
    """The kernel's arithmetic in plain PyTorch ops, in place on p, m, v."""
    c1, c2 = bias_corrections(b1, b2, step)
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    p.copy_(p - lr * (m * c1) / (torch.sqrt(v * c2) + eps))


@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("adam")
    P, L, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.adam_step.argtypes = [P] * 4 + [L] + [F] * 8 + [P]
    lib.adam_step.restype = ctypes.c_int
    return lib


def _launch_adam(p: Tensor, g: Tensor, m: Tensor, v: Tensor, lr: float,
                 b1: float, b2: float, eps: float, step: int) -> None:
    c1, c2 = bias_corrections(b1, b2, step)
    n = p.numel()
    if n == 0:  # csrc/adam.cu launches nothing for an empty leaf
        return
    err = _lib().adam_step(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, lr, b1, b2,
        1.0 - b1, 1.0 - b2, eps, c1, c2,
        torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel adam_step failed with cudaError {err}")
    LAUNCHES["adam"] += 1


@torch.no_grad()
def adam_step(p: Tensor, g: Tensor, m: Tensor, v: Tensor, *, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              step: int) -> None:
    """One Adam update of the leaf ``p`` from its gradient ``g``, in place.

    ``m`` and ``v`` are the leaf's first and second moments and ``step`` the
    number of this update, counted from 1. All four tensors are contiguous
    float32 of one shape on one device.
    """
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"{name} must be float32 on {p.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p.device.type == "cpu":
        return _adam_plain(p, g, m, v, lr, b1, b2, eps, step)
    if p.device.type == "cuda":
        return _launch_adam(p, g, m, v, lr, b1, b2, eps, step)
    raise ValueError(f"no Adam kernel for device {p.device}")
