"""Trajectory datasets for trajectory-to-trajectory training (host numpy).

Counterpart of ``tpu_cfd/data/datasets.py``, kept as a copy so that the port
imports nothing of the JAX package. Windows are sliced with numpy on the
host from a numpy ``Generator``, so the same seed draws the same batches as
the JAX package; the training pipeline can instead gather the same
``(idx, starts)`` windows on the card (``train.pipeline``). Both ``.npz``
(the native format) and torch ``.pt`` trajectory dicts load. The
normalizers wait for FNO3d (ROADMAP.md Queue A item 2).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

Array = np.ndarray


def load_trajectory_dict(path: Union[str, os.PathLike],
                         keys: Optional[Sequence[str]] = None) -> Dict[str, Array]:
    """Loads a trajectory dict from .npz (native) or torch .pt (reference).

    ``keys`` restricts which arrays of an .npz are read (np.load is lazy per
    entry).
    """
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            names = z.files if keys is None else [k for k in z.files if k in keys]
            return {k: z[k] for k in names}
    if path.suffix in (".pt", ".pth"):
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
                for k, v in data.items()}
    if path.suffix == ".mat":
        raise NotImplementedError(
            ".mat datasets are not ported yet: they wait for ROADMAP.md Queue A item 2 "
            "(MATLAB/HDF5 loading with the FNO3d slice)")
    raise ValueError(f"unsupported data format: {path.suffix}")


class SpatioTemporalDataset:
    """Random-window trajectory dataset.

    Trajectories are stored ``(N, T, n, n)``; ``sample`` slices a random (or
    fixed ``T_start``) input window of ``steps`` frames and the following
    ``out_steps`` frames, returning time-last arrays ``(b, n, n, steps)``.
    """

    def __init__(
        self,
        data_path: Union[str, os.PathLike, Dict[str, Array]],
        n_samples: int = 1024,
        train: bool = True,
        fields: Sequence[str] = ("vorticity", "stream"),
        data_time_last: bool = False,
        steps: int = 10,
        out_steps: Optional[int] = None,
        T_start: Optional[int] = None,
        dtype=np.float32,
    ):
        self.fields = list(fields)
        self.steps = steps
        self.out_steps = out_steps if out_steps is not None else steps
        self.T_start = T_start
        self.dtype = dtype

        data = (data_path if isinstance(data_path, dict)
                else load_trajectory_dict(data_path, keys=self.fields))
        data = {k: np.asarray(v) for k, v in data.items() if k in self.fields}
        # datasets generated without --extra-vars store the auxiliary fields
        # as empty arrays: drop them, but a requested field with no key at
        # all is a mismatch worth a warning
        absent = [f for f in self.fields if f not in data]
        data = {k: v for k, v in data.items() if v.size}
        if self.fields[0] not in data:
            raise KeyError(f"primary field {self.fields[0]!r} not in dataset "
                           f"(available: {sorted(data)})")
        if absent:
            warnings.warn(f"requested fields {absent} not present in dataset "
                          f"(available: {sorted(data)}); proceeding without them",
                          stacklevel=2)
        self.fields = [f for f in self.fields if f in data]
        first = data[self.fields[0]]
        if not data_time_last:
            data = {k: np.moveaxis(v, 1, -1) for k, v in data.items()}
        n_samples = min(n_samples, first.shape[0])
        if train:
            data = {k: v[:n_samples] for k, v in data.items()}
        else:
            data = {k: v[-n_samples:] for k, v in data.items()}
        self.data = data
        self.n_samples = n_samples
        self.total_steps = self.data[self.fields[0]].shape[-1]

    def __len__(self) -> int:
        return self.n_samples

    def draw_starts(self, idx: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Window starts, one independent draw per sample."""
        idx = np.atleast_1d(np.asarray(idx))
        window = self.out_steps + self.steps
        if self.T_start is None:
            rng = np.random.default_rng() if rng is None else rng
            return rng.integers(0, self.total_steps - (window + 1), size=len(idx))
        return np.full(len(idx), self.T_start, dtype=np.int64)

    def sample(self, idx: np.ndarray, rng: Optional[np.random.Generator] = None
               ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        """Slices input/output windows for a batch of sample indices."""
        idx = np.atleast_1d(np.asarray(idx))
        return self.sample_at(idx, self.draw_starts(idx, rng))

    def sample_at(self, idx: np.ndarray, starts: np.ndarray
                  ) -> Tuple[Dict[str, Array], Dict[str, Array]]:
        """Deterministic window slicing at explicit per-sample ``starts``.

        The host reference for the windows that the device-resident
        training path gathers on the card from the same (idx, starts).
        """
        idx = np.atleast_1d(np.asarray(idx))
        starts = np.atleast_1d(np.asarray(starts))
        inp_t = starts[:, None] + np.arange(self.steps)
        out_t = starts[:, None] + self.steps + np.arange(self.out_steps)

        def gather(arr, t_idx):
            return np.take_along_axis(arr, t_idx[:, None, None, :], axis=-1)

        inp = {f: gather(self.data[f][idx], inp_t).astype(self.dtype)
               for f in self.fields}
        out = {f: gather(self.data[f][idx], out_t).astype(self.dtype)
               for f in self.fields}
        inp["time_steps"] = inp_t
        out["time_steps"] = out_t
        return inp, out

    def epoch_indices(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's (idx, starts), each ``(n_batches, batch_size)`` int32.

        Draws from ``rng`` in the order ``batches()`` does (permutation
        first, then one ``integers`` call per batch).
        """
        order = (rng.permutation(self.n_samples) if shuffle
                 else np.arange(self.n_samples))
        idx, starts = [], []
        for i in range(0, self.n_samples - batch_size + 1, batch_size):
            chunk = order[i: i + batch_size]
            idx.append(chunk)
            starts.append(self.draw_starts(chunk, rng))
        return (np.asarray(idx, dtype=np.int32).reshape(-1, batch_size),
                np.asarray(starts, dtype=np.int32).reshape(-1, batch_size))

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True):
        """Yields (input, output) dict batches for one epoch."""
        idx, starts = self.epoch_indices(batch_size, rng, shuffle)
        for chunk, s in zip(idx, starts):
            yield self.sample_at(chunk, s)
