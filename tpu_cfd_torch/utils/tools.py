"""Determinism, timing and introspection helpers (PyTorch).

Counterpart of ``tpu_cfd/utils/tools.py`` (the reference's ``fno/utils.py``:
get_seed :16-53, timer :72-117, get_num_params :186, get_config :194,
clones :215, check_nan :237).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Any, Dict, Iterable, Union

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor


def get_seed(s: int, printout: bool = True) -> torch.Generator:
    """Seeds numpy's and torch's global state and returns a
    ``torch.Generator`` seeded with ``s`` for explicit draws (the port's
    counterpart of JAX's master ``PRNGKey``)."""
    np.random.seed(s)
    torch.manual_seed(s)
    os.environ["PYTHONHASHSEED"] = str(s)
    if printout:
        print("\n".join([
            f"np.random.seed({s})",
            f"torch.manual_seed({s})",
            f"generator = torch.Generator().manual_seed({s})",
            "per-sample draws: solvers.initial_conditions.sample_generator(seed, idx)",
        ]))
    return torch.Generator().manual_seed(s)


@contextlib.contextmanager
def timer(label: str = "", verbose: bool = True):
    """Wall clock, and the host RSS change where psutil is importable.

    Yields a dict whose ``seconds`` (and ``rss_mb``) are filled at exit.
    When a card is in use it is synchronised at exit, so that the time
    covers the work queued inside the block.
    """
    try:
        import psutil

        proc = psutil.Process()
        rss0 = proc.memory_info().rss
    except ImportError:
        proc = None
    t0 = time.perf_counter()
    result = {"seconds": None, "rss_mb": None}
    try:
        yield result
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        result["seconds"] = time.perf_counter() - t0
        if proc is not None:
            result["rss_mb"] = (proc.memory_info().rss - rss0) / 2 ** 20
        if verbose:
            mem = f" | ΔRSS {result['rss_mb']:+.1f} MB" if proc is not None else ""
            print(f"[timer] {label}: {result['seconds']:.4f}s{mem}")


def _leaves(params: Union[nn.Module, Dict[str, Tensor], Iterable[Tensor]]):
    if isinstance(params, nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def get_num_params(params) -> int:
    """Counts the entries of a module's parameters (or of a dict or list of
    tensors); complex leaves count twice."""
    return sum(t.numel() * (2 if t.is_complex() else 1) for t in _leaves(params))


def get_size(params) -> float:
    """Total parameter bytes in MB."""
    return sum(t.numel() * t.element_size() for t in _leaves(params)) / 2 ** 20


def get_config(obj: Any, logger=None) -> Dict[str, Any]:
    """Logs and returns an object's public scalar attributes."""
    config = {
        k: v for k, v in vars(obj).items()
        if not k.startswith("_") and not callable(v) and np.isscalar(v)
    } if hasattr(obj, "__dict__") else {}
    line = " | ".join(f"{k}={v}" for k, v in config.items())
    if logger is not None:
        logger.info(f"{type(obj).__name__}: {line}")
    else:
        print(f"{type(obj).__name__}: {line}")
    return config


def check_nan(tensor: Tensor, tensor_name: str = "tensor") -> None:
    """Raises if a tensor holds a NaN (a host check: it synchronises)."""
    if bool(torch.isnan(tensor).any()):
        raise ValueError(f"NaN detected in {tensor_name}")


def clones(module: nn.Module, n: int) -> nn.ModuleList:
    """``n`` deep copies of ``module``: each with parameters of its own, as
    each layer has its own after flax's ``init``."""
    return nn.ModuleList(copy.deepcopy(module) for _ in range(n))
