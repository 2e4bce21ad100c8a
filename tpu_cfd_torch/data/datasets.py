"""Trajectory datasets for trajectory-to-trajectory training (host numpy).

Counterpart of ``tpu_cfd/data/datasets.py``, kept as a copy so that the port
imports nothing of the JAX package. Windows are sliced with numpy on the
host from a numpy ``Generator``, so the same seed draws the same batches as
the JAX package; the training pipeline can instead gather the same
``(idx, starts)`` windows on the card (``train.pipeline``). ``.npz`` (the
native format), torch ``.pt`` trajectory dicts and MATLAB ``.mat`` files (the
FNO paper's datasets) load. The Gaussian normalizers, the fixed-window
dataset and ``NavierStokesDataset`` serve the FNO3d baseline
(``train.train_fno3d``); they stay numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

Array = np.ndarray

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _resize_weights(n_in: int, n_out: int) -> Array:
    """``(n_in, n_out)`` weights of a linear resize along one axis.

    ``jax.image.resize(..., "linear")``'s: half-pixel sample centres and a
    triangle kernel, widened by the scale when shrinking (antialiasing), each
    output's weights normalised to sum to one.
    """
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear(a: Array, size: Sequence[int]) -> Array:
    """``a`` resampled to ``size`` by separable linear interpolation."""
    a = np.asarray(a, dtype=np.float32)
    if len(size) != a.ndim:
        raise ValueError(f"size {tuple(size)} does not match an array of "
                         f"{a.ndim} dimensions")
    for axis, n_out in enumerate(size):
        if n_out != a.shape[axis]:
            w = _resize_weights(a.shape[axis], n_out)
            a = np.moveaxis(np.tensordot(a, w, axes=([axis], [0])), -1, axis)
    return a


class UnitGaussianNormalizer:
    """Pointwise Gaussian normalizer (mean and std over the batch axis).

    With ``align_shapes`` the statistics are resampled linearly to the
    input's resolution, for evaluation on another grid.
    """

    def __init__(self, eps: float = 1e-7, data: Optional[Array] = None):
        self.eps = eps
        self.mean: Optional[Array] = None
        self.std: Optional[Array] = None
        if data is not None:
            self.fit_transform(data)

    def fit_transform(self, x: Array) -> Array:
        x = np.asarray(x)
        self.mean = x.mean(0).astype(np.float32)
        self.std = x.std(0).astype(np.float32)
        return (x - self.mean) / (self.std + self.eps)

    def _align_shapes(self, x) -> Tuple[Array, Array]:
        size = tuple(x.shape[1:])
        mean, std = self.mean, self.std
        if size != tuple(mean.shape):
            mean, std = resize_linear(mean, size), resize_linear(std, size)
        return mean, std

    def transform(self, x, align_shapes: bool = False):
        if self.mean is None:
            return x
        mean, std = self._align_shapes(x) if align_shapes else (self.mean, self.std)
        return (x - mean) / (std + self.eps)

    def inverse_transform(self, x, align_shapes: bool = True):
        if self.mean is None:
            return x
        mean, std = self._align_shapes(x) if align_shapes else (self.mean, self.std)
        return x * (std + self.eps) + mean

    def save(self, path: Union[str, os.PathLike]):
        np.savez(path, mean=self.mean, std=self.std, eps=self.eps)

    @classmethod
    def load(cls, path: Union[str, os.PathLike]) -> "UnitGaussianNormalizer":
        with np.load(path) as z:
            norm = cls(eps=float(z["eps"]))
            norm.mean, norm.std = z["mean"], z["std"]
        return norm


class SpatialGaussianNormalizer(UnitGaussianNormalizer):
    """Normalizes over the batch and time axes; data shaped (N, n, n, T)."""

    def fit_transform(self, x: Array) -> Array:
        x = np.asarray(x)
        self.mean = x.mean((0, -1))[..., None].astype(np.float32)
        self.std = x.std((0, -1))[..., None].astype(np.float32)
        return (x - self.mean) / (self.std + self.eps)


def _load_mat(path: Path) -> Dict[str, Array]:
    """A MATLAB file's arrays: v7.3 files are HDF5 (column-major, hence the
    transpose) and need h5py; older versions go through ``scipy.io``."""
    with open(path, "rb") as f:
        is_hdf5 = f.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE
    if is_hdf5:
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path} is a MATLAB v7.3 (HDF5) file, which needs the h5py "
                "package, and h5py is not installed; re-save it in an older "
                "format (scipy.io reads up to v7.2) or as .npz") from e
        with h5py.File(path, "r") as f:
            return {k: np.asarray(f[k]).T for k in f.keys()
                    if isinstance(f[k], h5py.Dataset)}
    import scipy.io as sio

    return {k: np.asarray(v) for k, v in sio.loadmat(path).items()
            if not k.startswith("__")}


def load_trajectory_dict(path: Union[str, os.PathLike],
                         keys: Optional[Sequence[str]] = None) -> Dict[str, Array]:
    """Loads a trajectory dict from .npz (native), torch .pt or MATLAB .mat.

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
        return _load_mat(path)
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


class SpatioTemporalDatasetFixedTime(SpatioTemporalDataset):
    """Fixed-window variant with a spatial Gaussian normalizer a field."""

    def __init__(self, *args, normalize: bool = True, T_start: int = 0, **kwargs):
        super().__init__(*args, T_start=T_start, **kwargs)
        self.normalizers: Dict[str, SpatialGaussianNormalizer] = {}
        if normalize:
            for f in self.fields:
                norm = SpatialGaussianNormalizer()
                self.data[f] = norm.fit_transform(self.data[f])
                self.normalizers[f] = norm


class NavierStokesDataset:
    """FNO-paper-format dataset: one tensor ``u`` shaped (N, n, n, T).

    Loads .mat/.pt/.npz (or takes the ``(N, n, n, T)`` array itself in
    place of a path), takes the first ``time_steps_input`` frames as input
    channels and the following ``time_steps_output`` frames as targets, with
    optional subsampling and Gaussian normalization of the input.
    """

    def __init__(self, data_path: Union[str, os.PathLike, Array], n_samples: int = 1024,
                 train: bool = True, time_steps_input: int = 10,
                 time_steps_output: int = 40, subsample: int = 1,
                 field: str = "u", normalize: bool = True, dtype=np.float32):
        if isinstance(data_path, (str, os.PathLike)):
            u = np.asarray(load_trajectory_dict(data_path)[field])
        else:
            u = np.asarray(data_path)
        s = subsample
        u = u[:, ::s, ::s, :]
        n_samples = min(n_samples, u.shape[0])
        u = u[:n_samples] if train else u[-n_samples:]
        self.a = u[..., :time_steps_input].astype(dtype)
        self.u = u[..., time_steps_input: time_steps_input + time_steps_output
                   ].astype(dtype)
        self.n_samples = n_samples
        self.normalizer: Optional[UnitGaussianNormalizer] = None
        if normalize:
            self.normalizer = UnitGaussianNormalizer()
            self.a = self.normalizer.fit_transform(self.a)

    def __len__(self) -> int:
        return self.n_samples

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle=True):
        order = (rng.permutation(self.n_samples) if shuffle
                 else np.arange(self.n_samples))
        for i in range(0, self.n_samples - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            yield {"a": self.a[idx], "u": self.u[idx]}
