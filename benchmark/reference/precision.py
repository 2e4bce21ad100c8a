"""TF32 rounding, for the controls: the references computed one precision
below the configurations' fp32.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits. A product of
two TF32 numbers is exact in float32, so rounding both operands of a float32
product to TF32 and accumulating in float32 is TF32 arithmetic, on any device.
"""

from __future__ import annotations

import torch

_DROP = 13  # float32 mantissa bits that TF32 lacks


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) rounded to TF32, ties to even."""
    x = x.detach()
    if x.is_complex():
        return torch.view_as_complex(to_tf32(torch.view_as_real(x)))
    if x.dtype != torch.float32:
        raise TypeError(f"to_tf32 takes float32 or complex64, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> _DROP) & 1
    half = (1 << (_DROP - 1)) - 1
    rounded = (bits + half + lsb) & ~((1 << _DROP) - 1)
    return rounded.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding in the forward pass, the gradient passed through."""

    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def rounder(tf32: bool):
    """The operand rounding of a control (``tf32``) or the identity. Under
    autograd the rounding is in the forward pass only."""
    return _Round.apply if tf32 else (lambda x: x)
