"""Carries solver state between the JAX package and the PyTorch port.

This slice has no learned weights, so what crosses is the solver's state:
spectra ``(..., n, n//2+1)`` (or a truncated layout) and physical fields
``(..., n, n)``, passed as numpy arrays. The flax -> ``state_dict``
converter comes with the model slice.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_cfd_torch.device import resolve_device

_COMPLEX = {np.dtype(np.complex64): torch.complex64,
            np.dtype(np.complex128): torch.complex128}
_REAL = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def spectrum_from_numpy(x, device=None) -> torch.Tensor:
    """A complex numpy spectrum as a tensor of the same dtype on ``device``."""
    x = np.asarray(x)
    if x.dtype not in _COMPLEX:
        raise ValueError(f"expected a complex64/complex128 spectrum, got {x.dtype}")
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def field_from_numpy(x, device=None) -> torch.Tensor:
    """A real numpy field as a tensor of the same dtype on ``device``."""
    x = np.asarray(x)
    if x.dtype not in _REAL:
        raise ValueError(f"expected a float32/float64 field, got {x.dtype}")
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def spectrum_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A complex tensor back to a host numpy array of the same dtype."""
    if not t.is_complex():
        raise ValueError(f"expected a complex tensor, got {t.dtype}")
    return t.detach().cpu().numpy()


def field_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A real tensor back to a host numpy array of the same dtype."""
    if t.is_complex():
        raise ValueError("expected a real tensor, got a complex one")
    return t.detach().cpu().numpy()
