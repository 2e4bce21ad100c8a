"""The inputs every cell makes from ``--seed``, on the device, in few calls.

The benchmark makes these and hands the same to the port and to the plain
references: noise for the initial conditions, trajectories to train on,
model weights and each epoch's batch indices. The port only receives them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for the stream ``tags`` of run ``seed`` (any
    whole number, also past 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *map(int, tags)]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *tags: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *tags))


def batch_noise(seed: int, batch: int, shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    """White noise of generation batch ``batch`` (``-1``: the warm-up's)."""
    g = generator(seed, 1, batch + 1, device=device)
    return torch.randn(shape, generator=g, dtype=dtype, device=device)


def smooth_trajectories(seed: int, tag: int, count: int, n: int, frames: int,
                        device, dtype=torch.float32, chunk: int = 32) -> torch.Tensor:
    """``(count, n, n, frames)`` random fields, time last, smooth in space
    and time: white noise filtered by ``(1 + |k|^2 / 16)^-2`` in (t, x, y)
    over ``n`` and ``frames``, each sample scaled to unit variance."""
    kt = torch.fft.fftfreq(frames, d=1.0 / frames, device=device)
    kx = torch.fft.fftfreq(n, d=1.0 / n, device=device)
    ky = torch.fft.rfftfreq(n, d=1.0 / n, device=device)
    k2 = kt[:, None, None] ** 2 + kx[None, :, None] ** 2 + ky[None, None, :] ** 2
    filt = (1 + k2 / 16.0) ** -2
    out = torch.empty((count, n, n, frames), dtype=dtype, device=device)
    g = generator(seed, 2, tag, device=device)
    for lo in range(0, count, chunk):
        hi = min(lo + chunk, count)
        noise = torch.randn((hi - lo, frames, n, n), generator=g, dtype=dtype, device=device)
        field = torch.fft.irfftn(torch.fft.rfftn(noise, dim=(1, 2, 3)) * filt,
                                 s=(frames, n, n), dim=(1, 2, 3))
        field = field / field.flatten(1).std(dim=1)[:, None, None, None]
        out[lo:hi] = field.permute(0, 2, 3, 1)
    return out


def weights(spec: List[tuple], seed: int, device, dtype=torch.float32
            ) -> Dict[str, torch.Tensor]:
    """Parameters by name from ``(name, shape, init, scale)`` entries: one
    normal draw for all dense weights (truncated at two standard deviations),
    one uniform draw for all spectral weights, zeros and ones."""
    g = generator(seed, 3, device=device)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g, dtype=dtype,
                                   device=device).clamp_(-2, 2),
             "uniform": torch.rand(sizes["uniform"], generator=g, dtype=dtype, device=device)}
    taken = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in spec:
        if kind in pools:
            size = math.prod(shape)
            lo = taken[kind]
            out[name] = (pools[kind][lo: lo + size] * scale).reshape(shape)
            taken[kind] += size
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out


def epoch_indices(n_samples: int, total_steps: int, window: int, batch: int,
                  rng: np.random.Generator, shuffle: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One epoch's ``(idx, starts)``, each ``(n_batches, batch)``: a
    permutation of the samples in batches and one window start a sample,
    drawn in the training CLI's order (the permutation, then one draw a
    batch from ``[0, total_steps - window - 1)``)."""
    order = rng.permutation(n_samples) if shuffle else np.arange(n_samples)
    idx, starts = [], []
    for i in range(0, n_samples - batch + 1, batch):
        chunk = order[i: i + batch]
        idx.append(chunk)
        starts.append(rng.integers(0, total_steps - (window + 1), size=len(chunk)))
    return (np.asarray(idx, dtype=np.int32).reshape(-1, batch),
            np.asarray(starts, dtype=np.int32).reshape(-1, batch))
