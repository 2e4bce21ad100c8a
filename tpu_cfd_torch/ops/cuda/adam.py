"""One-pass Adam update of a list of parameter leaves: CUDA kernel and wrappers.

Replaces the TPU kernel ``scripts/opt_layout_r4.py::fused_adam_pallas`` (its
``kernel`` body, the ``pallas_call`` in ``apply_leaf``). ``csrc/adam.cu``
reads ``p, g, m, v`` once and writes ``p, m, v`` once, for up to
``MAX_LEAVES`` leaves in one launch (see its header for the bound and the
design); the TPU version's merged views, which exist to fill 128 lanes, have
no counterpart, since the kernel indexes a contiguous leaf linearly.

- ``AdamLeaves(params, ms, vs)`` checks the leaves and plans their launches
  once; ``.step(grads, ...)`` then checks only the gradients and makes one
  launch a group of ``MAX_LEAVES`` leaves. An optimizer keeps one and calls
  it every step.
- ``adam_step_leaves(params, grads, ms, vs, ...)`` is the same update in one
  call, with every tensor checked.
- ``adam_step(p, g, m, v, ...)`` updates one leaf through the same kernel.

Each updates ``p``, ``m`` and ``v`` in place (the JAX function donates
them): the kernel on CUDA tensors, the plain PyTorch version
(``_adam_plain``, leaf by leaf) on CPU tensors, an error on anything else.
The bias corrections come from the host's ``step`` count, so a step costs no
synchronisation. ``eps`` stands outside the root, as in ``optax.adam`` and
``torch.optim.Adam``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Kernel launches, and leaves those launches updated, since the last
# reset_launch_counts().
LAUNCHES = {"adam": 0, "adam_leaves": 0}

MAX_LEAVES = 64      # leaves a launch: the kernel's parameter table (csrc/adam.cu)
CHUNK = 16384        # floats a block (csrc/adam.cu)
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


def plan_launches(numels: Sequence[int], max_leaves: int = MAX_LEAVES,
                  chunk: int = CHUNK) -> List[Tuple[List[int], List[int], int]]:
    """Cuts a list of leaves into launches: ``(leaf indices, first chunk of
    each, chunks in all)`` a launch, at most ``max_leaves`` leaves each, in
    order, empty leaves skipped. Block ``b`` of a launch updates the leaf
    whose chunks ``[first, next first)`` hold ``b``."""
    groups, idx, first, total = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(idx) == max_leaves:
            groups.append((idx, first, total))
            idx, first, total = [], [], 0
        idx.append(i)
        first.append(total)
        total += -(-n // chunk)
    if idx:
        groups.append((idx, first, total))
    return groups


@functools.lru_cache(maxsize=None)
def _lib():
    from tpu_cfd_torch.ops.cuda import _build

    lib = _build.load("adam")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adam_step_leaves.argtypes = [P, I, I] + [F] * 8 + [P]
    lib.adam_step_leaves.restype = I
    return lib


def _launch(rows: np.ndarray, chunks: int, device, lr: float, b1: float,
            b2: float, eps: float, c1: float, c2: float) -> None:
    """One launch over the leaves of ``rows`` (int64: p, g, m, v, n, first chunk)."""
    lib = _lib()
    # a launch goes to the host thread's current device: make it the leaves'
    with torch.cuda.device(device):
        err = lib.adam_step_leaves(
            rows.ctypes.data, len(rows), chunks, lr, b1, b2, 1.0 - b1, 1.0 - b2,
            eps, c1, c2, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel adam_step_leaves failed with cudaError {err}")
    LAUNCHES["adam"] += 1
    LAUNCHES["adam_leaves"] += len(rows)


def _launch_adam(p: Tensor, g: Tensor, m: Tensor, v: Tensor, lr: float,
                 b1: float, b2: float, eps: float, step: int) -> None:
    c1, c2 = bias_corrections(b1, b2, step)
    n = p.numel()
    if n == 0:  # nothing to launch for an empty leaf
        return
    rows = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, 0]],
                    dtype=np.int64)
    _launch(rows, -(-n // CHUNK), p.device, lr, b1, b2, eps, c1, c2)


def _check(t: Tensor, name: str, device, shape) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_device(device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Adam kernel for device {device}")


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
        _check(t, name, p.device, p.shape)
    _kernel_device(p.device)
    if p.device.type == "cpu":
        return _adam_plain(p, g, m, v, lr, b1, b2, eps, step)
    return _launch_adam(p, g, m, v, lr, b1, b2, eps, step)


class AdamLeaves:
    """The parameters and moments of a list of leaves, checked once, with
    their launches planned and their pointers packed.

    ``step(grads, ...)`` updates every leaf in place and checks only the
    gradients (new tensors each step) and that no parameter's storage has
    moved since the table was built. The table keeps references to the
    tensors it was given.
    """

    def __init__(self, params: Sequence[Tensor], ms: Sequence[Tensor],
                 vs: Sequence[Tensor]):
        params, ms, vs = list(params), list(ms), list(vs)
        if not len(params) == len(ms) == len(vs):
            raise ValueError(f"{len(params)} params, {len(ms)} ms and {len(vs)} vs")
        self.device = params[0].device if params else torch.device("cpu")
        _kernel_device(self.device)
        for i, (p, m, v) in enumerate(zip(params, ms, vs)):
            for name, t in (("params", p), ("ms", m), ("vs", v)):
                _check(t, f"{name}[{i}]", self.device, p.shape)
        self.params, self.ms, self.vs = params, ms, vs
        self.shapes = [p.shape for p in params]
        self._groups = []
        if self.device.type == "cuda":
            for idx, first, chunks in plan_launches([p.numel() for p in params]):
                rows = np.zeros((len(idx), 6), dtype=np.int64)
                for col, ts in ((0, params), (2, ms), (3, vs)):
                    rows[:, col] = [ts[i].data_ptr() for i in idx]
                rows[:, 4] = [params[i].numel() for i in idx]
                rows[:, 5] = first
                self._groups.append((idx, rows, chunks))

    @torch.no_grad()
    def step(self, grads: Sequence[Tensor], *, lr: float, b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-8, step: int) -> None:
        """One Adam update of every leaf; ``step`` counts from 1."""
        c1, c2 = bias_corrections(b1, b2, step)
        if len(grads) != len(self.shapes):
            raise ValueError(f"{len(grads)} grads for {len(self.shapes)} leaves")
        f32, dev = torch.float32, self.device
        for i, (g, shape) in enumerate(zip(grads, self.shapes)):
            if (g.dtype != f32 or g.device != dev or g.shape != shape
                    or not g.is_contiguous()):
                _check(g, f"grads[{i}]", dev, shape)
        if dev.type == "cpu":
            for p, g, m, v in zip(self.params, grads, self.ms, self.vs):
                _adam_plain(p, g, m, v, lr, b1, b2, eps, step)
            return
        for idx, rows, chunks in self._groups:
            if [self.params[i].data_ptr() for i in idx] != rows[:, 0].tolist():
                raise ValueError("a parameter's storage moved since the AdamLeaves "
                                 "table was built: build a new one")
            rows[:, 1] = [grads[i].data_ptr() for i in idx]
            _launch(rows, chunks, dev, lr, b1, b2, eps, c1, c2)


def adam_step_leaves(params: Sequence[Tensor], grads: Sequence[Tensor],
                     ms: Sequence[Tensor], vs: Sequence[Tensor], *, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     step: int) -> None:
    """One Adam update of every leaf ``params[i]`` from ``grads[i]``, in place,
    with one launch a group of ``MAX_LEAVES`` leaves; each leaf as in
    ``adam_step``. Checks every tensor on every call; a caller that updates
    the same leaves each step keeps an ``AdamLeaves`` instead."""
    AdamLeaves(params, ms, vs).step(grads, lr=lr, b1=b1, b2=b2, eps=eps, step=step)
