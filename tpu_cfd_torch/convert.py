"""Carries state and parameters between the JAX package and the PyTorch port.

Solver state crosses as numpy arrays: spectra ``(..., n, n//2+1)`` (or a
truncated layout) and physical fields ``(..., n, n)``.

Model parameters cross as a flax parameter tree of nested dicts of numpy
arrays (with or without the outer ``{"params": ...}``) and a PyTorch
``state_dict``. A Dense ``kernel`` ``(in, out)`` becomes ``nn.Linear.weight``
``(out, in)``; spectral ``weight_i``/``bias_i`` keep their real-pair layout.
The flax names of each module map to the port's attributes:

- ``SFNO``: ``LiftingOperator_0`` → ``lifting``, ``SpectralConvS_{i}`` →
  ``convs.{i}``, ``PointwiseFFN_{i}`` → ``ffns.{i}``, the top-level
  ``Dense_0..Dense_{L-2}`` (the 1×1 skips) → ``skips.{i}``, ``Dense_{L-1}``
  (the width → out_dim reduction) → ``reduce``, ``OutConv_0`` → ``out_conv``;
- ``LiftingOperator``: ``SpaceTimePositionalEncoding_0/Dense_0`` → ``pe.dense``
  (random features only), ``LayerNormnd_0`` → ``norm``, ``Dense_0`` →
  ``dense``, ``SpectralConvT_0`` → ``conv``, ``PointwiseFFN_0`` → ``ffn`` (or
  ``Dense_1`` → ``linear`` for a linear lifting);
- ``PointwiseFFN``: ``Dense_0``/``Dense_1`` → ``dense_0``/``dense_1``;
- ``OutConv``: ``SpectralConvT_0`` → ``conv``;
- ``OutConvFT`` (the fine-tune's): ``OutConv_0`` → ``out_conv``;
- ``FNO3d``: ``Dense_0`` (the lifting) → ``lift``, ``SpectralConv3d_{i}`` →
  ``convs.{i}``, ``MLP3d_{i}`` → ``mlps.{i}``, ``Dense_{i+1}`` (the 1×1 skips)
  → ``skips.{i}``, ``MLP3d_{L}`` (the output head) → ``head``;
- ``MLP3d``: ``Dense_0``/``Dense_1`` → ``dense_0``/``dense_1``.

A key the mapping does not know, or one it expects and does not find,
raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

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


# ------------------------------------------------------------ parameters ----

_Leaf = Tuple[str, bool]  # (torch key, transpose)


def _dense(prefix: str) -> Dict[tuple, _Leaf]:
    return {("kernel",): (prefix + "weight", True), ("bias",): (prefix + "bias", False)}


def _nest(flax_name: str, torch_prefix: str, sub: Dict[tuple, _Leaf]):
    return {(flax_name, *k): (torch_prefix + t, tr) for k, (t, tr) in sub.items()}


def _layer_norm(prefix: str, tree) -> Dict[tuple, _Leaf]:
    return {("scale",): (prefix + "scale", False), ("bias",): (prefix + "bias", False)}


def _spectral(prefix: str, tree) -> Dict[tuple, _Leaf]:
    """weight_0..3, and bias_0..3 when the tree has any bias."""
    names = [f"weight_{i}" for i in range(4)]
    if any(str(k).startswith("bias_") for k in tree):
        names += [f"bias_{i}" for i in range(4)]
    return {(n,): (prefix + n, False) for n in names}


def _ffn(prefix: str, tree) -> Dict[tuple, _Leaf]:
    return {**_nest("Dense_0", "", _dense(prefix + "dense_0.")),
            **_nest("Dense_1", "", _dense(prefix + "dense_1."))}


def _pe(prefix: str, tree) -> Dict[tuple, _Leaf]:
    return _nest("Dense_0", "", _dense(prefix + "dense.")) if "Dense_0" in tree else {}


def _lifting(prefix: str, tree) -> Dict[tuple, _Leaf]:
    out = {}
    if "SpaceTimePositionalEncoding_0" in tree:
        out.update(_nest("SpaceTimePositionalEncoding_0", "",
                         _pe(prefix + "pe.", tree["SpaceTimePositionalEncoding_0"])))
    out.update(_nest("LayerNormnd_0", "", _layer_norm(prefix + "norm.", None)))
    out.update(_nest("Dense_0", "", _dense(prefix + "dense.")))
    out.update(_nest("SpectralConvT_0", "",
                     _spectral(prefix + "conv.", tree.get("SpectralConvT_0", {}))))
    if "PointwiseFFN_0" in tree or "Dense_1" not in tree:
        out.update(_nest("PointwiseFFN_0", "", _ffn(prefix + "ffn.", None)))
    else:
        out.update(_nest("Dense_1", "", _dense(prefix + "linear.")))
    return out


def _out_conv(prefix: str, tree) -> Dict[tuple, _Leaf]:
    return _nest("SpectralConvT_0", "",
                 _spectral(prefix + "conv.", tree.get("SpectralConvT_0", {})))


def _out_conv_ft(prefix: str, tree) -> Dict[tuple, _Leaf]:
    return _nest("OutConv_0", "", _out_conv(prefix + "out_conv.", tree.get("OutConv_0", {})))


def _sfno(prefix: str, tree) -> Dict[tuple, _Leaf]:
    layers = sum(1 for k in tree if re.fullmatch(r"SpectralConvS_\d+", str(k)))
    out = {}
    out.update(_nest("LiftingOperator_0", "",
                     _lifting(prefix + "lifting.", tree.get("LiftingOperator_0", {}))))
    for i in range(layers):
        out.update(_nest(f"SpectralConvS_{i}", "",
                         _spectral(f"{prefix}convs.{i}.", {})))
        out.update(_nest(f"PointwiseFFN_{i}", "", _ffn(f"{prefix}ffns.{i}.", None)))
        out.update(_nest(f"Dense_{i}", "", _dense(f"{prefix}skips.{i}.")))
    out.update(_nest(f"Dense_{layers}", "", _dense(prefix + "reduce.")))
    out.update(_nest("OutConv_0", "",
                     _out_conv(prefix + "out_conv.", tree.get("OutConv_0", {}))))
    return out


def _fno3d(prefix: str, tree) -> Dict[tuple, _Leaf]:
    layers = sum(1 for k in tree if re.fullmatch(r"SpectralConv3d_\d+", str(k)))
    out = _nest("Dense_0", "", _dense(prefix + "lift."))
    for i in range(layers):
        out.update(_nest(f"SpectralConv3d_{i}", "",
                         _spectral(f"{prefix}convs.{i}.", {})))
        out.update(_nest(f"MLP3d_{i}", "", _ffn(f"{prefix}mlps.{i}.", None)))
        out.update(_nest(f"Dense_{i + 1}", "", _dense(f"{prefix}skips.{i}.")))
    out.update(_nest(f"MLP3d_{layers}", "", _ffn(prefix + "head.", None)))
    return out


_MODULES: Dict[str, Callable] = {
    "SFNO": _sfno,
    "FNO3d": _fno3d,
    "MLP3d": _ffn,
    "LiftingOperator": _lifting,
    "OutConv": _out_conv,
    "OutConvFT": _out_conv_ft,
    "SpaceTimePositionalEncoding": _pe,
    "SpectralConv": _spectral,
    "PointwiseFFN": _ffn,
    "LayerNormnd": _layer_norm,
    "Dense": lambda prefix, tree: _dense(prefix),
}


def _flatten(tree, path=()) -> Dict[tuple, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, path + (str(k),)))
        return out
    return {path: np.asarray(tree)}


def _unwrap(tree):
    return tree["params"] if set(tree) == {"params"} else tree


def _key_map(module: str, tree) -> Dict[tuple, _Leaf]:
    if module not in _MODULES:
        raise ValueError(f"unknown module {module!r}; available: {sorted(_MODULES)}")
    return _MODULES[module]("", tree)


def state_dict_from_flax(module: str, params) -> Dict[str, torch.Tensor]:
    """A flax parameter tree of ``module`` as the port's ``state_dict``.

    ``module`` names the flax class (``"SFNO"``, ``"FNO3d"``,
    ``"LiftingOperator"``, ``"OutConv"``, ``"OutConvFT"``, ``"SpectralConv"`` for
    SpectralConvS/T/3d, ``"PointwiseFFN"``, ``"MLP3d"``, ``"LayerNormnd"``,
    ``"Dense"``, ``"SpaceTimePositionalEncoding"``).
    """
    tree = _unwrap(params)
    flat = _flatten(tree)
    keys = _key_map(module, tree)
    unknown = sorted("/".join(k) for k in set(flat) - set(keys))
    missing = sorted("/".join(k) for k in set(keys) - set(flat))
    if unknown or missing:
        raise KeyError(f"flax {module} parameters do not match the port: "
                       f"unknown {unknown}, missing {missing}")
    out = {}
    for path, (name, transpose) in keys.items():
        a = flat[path].T if transpose else flat[path]
        out[name] = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out


def flax_from_state_dict(module: str, state_dict) -> dict:
    """The port's ``state_dict`` of ``module`` back as a flax tree of numpy arrays.

    The flax layout is read off the state dict's keys. Returns the tree
    without the ``params`` wrapper.
    """
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    keys = _key_map(module, _skeleton(module, sd))
    by_name = {name: (path, tr) for path, (name, tr) in keys.items()}
    unknown = sorted(set(sd) - set(by_name))
    missing = sorted(set(by_name) - set(sd))
    if unknown or missing:
        raise KeyError(f"{module} state_dict does not match flax: unknown "
                       f"{unknown}, missing {missing}")
    tree: dict = {}
    for name, (path, transpose) in by_name.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(sd[name].T if transpose else sd[name])
    return tree


def _skeleton(module: str, sd) -> dict:
    """The flax-side facts the key map reads (layer count, optional modules)."""
    if module == "SpectralConv":
        return {"bias_0": None} if "bias_0" in sd else {}
    if module == "SpaceTimePositionalEncoding":
        return {"Dense_0": None} if "dense.weight" in sd else {}
    if module == "FNO3d":
        layers = len({k.split(".")[1] for k in sd if k.startswith("convs.")})
        return {f"SpectralConv3d_{i}": {} for i in range(layers)}
    if module not in ("SFNO", "LiftingOperator", "OutConv", "OutConvFT"):
        return {}
    pre = "lifting." if module == "SFNO" else ""
    lift = {}
    if pre + "pe.dense.weight" in sd:
        lift["SpaceTimePositionalEncoding_0"] = {"Dense_0": None}
    lift["PointwiseFFN_0" if pre + "ffn.dense_0.weight" in sd else "Dense_1"] = None
    out = {"SpectralConvT_0": {"bias_0": None}}
    if module == "LiftingOperator":
        return lift
    if module == "OutConv":
        return out
    if module == "OutConvFT":
        return {"OutConv_0": out}
    layers = len({k.split(".")[1] for k in sd if k.startswith("convs.")})
    skel = {"LiftingOperator_0": lift, "OutConv_0": out}
    skel.update({f"SpectralConvS_{i}": {} for i in range(layers)})
    return skel


def sfno_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ``SFNO`` parameter tree as the port's ``SFNO.state_dict()``."""
    return state_dict_from_flax("SFNO", params)


def sfno_flax_from_state_dict(state_dict) -> dict:
    """The port's ``SFNO.state_dict()`` as a flax parameter tree (no wrapper)."""
    return flax_from_state_dict("SFNO", state_dict)


def fno3d_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ``FNO3d`` parameter tree as the port's ``FNO3d.state_dict()``."""
    return state_dict_from_flax("FNO3d", params)


def fno3d_flax_from_state_dict(state_dict) -> dict:
    """The port's ``FNO3d.state_dict()`` as a flax parameter tree (no wrapper)."""
    return flax_from_state_dict("FNO3d", state_dict)
