"""Slicing and splitting of tensors, or of nested tuples and lists of them.

Counterpart of ``tpu_cfd/tensor_utils.py``. Where the JAX package walks a
pytree, these functions walk nested tuples and lists (and the grid vectors,
which are tuples) and keep their structure; every other leaf is a tensor.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple, Union

import torch

Nested = Any  # a tensor, or a tuple or list of Nested


def _leaves(inputs: Nested) -> List[torch.Tensor]:
    if isinstance(inputs, (tuple, list)):
        return [leaf for x in inputs for leaf in _leaves(x)]
    return [inputs]


def _map(fn: Callable[[torch.Tensor], torch.Tensor], inputs: Nested) -> Nested:
    if isinstance(inputs, (tuple, list)):
        return type(inputs)([_map(fn, x) for x in inputs])
    return fn(inputs)


def slice_along_axis(inputs: Nested, axis: int, idx: Union[slice, int],
                     expect_same_dims: bool = True) -> Nested:
    """Slices every tensor of ``inputs`` along ``axis`` (may be negative)
    with ``idx``, a ``slice`` or an integer (which drops the axis).

    With ``expect_same_dims``, all tensors must have the same ndim.
    """
    ndims = {leaf.ndim for leaf in _leaves(inputs)}
    if expect_same_dims and len(ndims) != 1:
        raise ValueError(
            "arrays in `inputs` expected to have same ndims, but have "
            f"{ndims}. To allow this, pass expect_same_dims=False"
        )

    def cut(leaf: torch.Tensor) -> torch.Tensor:
        ndim = leaf.ndim
        return leaf[tuple(idx if k == axis % ndim else slice(None) for k in range(ndim))]

    return _map(cut, inputs)


def split_along_axis(inputs: Nested, split_idx: int, axis: int,
                     expect_same_dims: bool = True) -> Tuple[Nested, Nested]:
    """Splits every tensor into two at ``split_idx`` along ``axis``."""
    first = slice_along_axis(inputs, axis, slice(0, split_idx), expect_same_dims)
    second = slice_along_axis(inputs, axis, slice(split_idx, None), expect_same_dims)
    return first, second


def split_axis(inputs: Nested, axis: int, keep_dims: bool = False) -> Tuple[Nested, ...]:
    """Splits ``inputs`` along ``axis`` into unit slices, one for each index;
    without ``keep_dims`` the axis is dropped. Every tensor must have the same
    size along ``axis``."""
    leaves = _leaves(inputs)
    if not leaves:
        raise ValueError("inputs has no array leaves")
    axis_shapes = {leaf.shape[axis] for leaf in leaves}
    if len(axis_shapes) != 1:
        raise ValueError(f"arrays must have equal sized axis but got {axis_shapes}")
    (axis_shape,) = axis_shapes
    return tuple(slice_along_axis(inputs, axis, i if not keep_dims else slice(i, i + 1))
                 for i in range(axis_shape))
