"""Every public name of the JAX package has its counterpart in the port.

``spectral_div_2d`` and ``fft_expand_dims`` are held to the JAX package's in
fp64 (the velocity of ``tests/test_spectral_solver.py:48``, and a velocity
that is not divergence-free). Then each name that a ``tpu_cfd`` package's
``__init__.py`` exports, and each public function, class and constant that
a ``tpu_cfd`` module defines, is found in the port: in the package or module
of the same path (the Pallas modules' counterparts are named in
``MODULES``), or under the name ``RENAMES`` gives it.
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import grids as jgrids
from tpu_cfd.ops import spectral as jspectral
from tpu_cfd.solvers import initial_conditions as jic
from tpu_cfd_torch import grids as tgrids
from tpu_cfd_torch.ops import spectral as tspectral

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the port's module for each JAX module whose path it does not share
MODULES = {
    "tpu_cfd.ops.pallas": "tpu_cfd_torch.ops.cuda",
    "tpu_cfd.ops.pallas.ffn": "tpu_cfd_torch.ops.cuda.ffn",
    "tpu_cfd.ops.pallas.spectral_step": "tpu_cfd_torch.ops.cuda.spectral_step",
    "tpu_cfd.models.pallas_conv": "tpu_cfd_torch.models.fused_conv",
}
# JAX names whose counterpart the port names otherwise: "module.name" -> the
# counterpart's dotted path (docstrings of the port's modules say the same)
RENAMES = {
    # functions of a flax parameter tree there, the module's own here
    "tpu_cfd.models.apply_with_latents": "tpu_cfd_torch.models.forward_with_latents",
    "tpu_cfd.models.base.apply_with_latents":
        "tpu_cfd_torch.models.base.forward_with_latents",
    "tpu_cfd.models.params_to_double": "torch.nn.Module.double",
    "tpu_cfd.models.base.params_to_double": "torch.nn.Module.double",
    # lax.scan epochs there, device-resident epochs here
    "tpu_cfd.train.pipeline.make_scan_epoch": "tpu_cfd_torch.train.pipeline.make_device_epoch",
    "tpu_cfd.train.pipeline.make_scan_eval": "tpu_cfd_torch.train.pipeline.make_device_eval",
    # the Pallas kernels' wrappers
    "tpu_cfd.ops.pallas.ffn.fused_pointwise_ffn": "tpu_cfd_torch.ops.cuda.ffn.pointwise_ffn",
    "tpu_cfd.models.pallas_conv.fused_spectral_conv_s_vjp":
        "tpu_cfd_torch.models.fused_conv.fused_spectral_conv_s",
}
# the type aliases of the JAX modules: jax.Array, and a pytree (Any)
ALIASES = {"Array": "torch.Tensor", "PyTree": "typing.Any"}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _exported(path: pathlib.Path) -> list:
    """The public names an ``__init__.py`` binds: its imports and definitions."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def _defined(path: pathlib.Path) -> list:
    """The public functions, classes and assigned names a module defines
    (not what it imports)."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


JAX_FILES = sorted((ROOT / "tpu_cfd").rglob("*.py"))
EXPORTS = [(_module_name(p), n) for p in JAX_FILES if p.name == "__init__.py"
           for n in _exported(p)]
DEFINITIONS = [(_module_name(p), n) for p in JAX_FILES if p.name != "__init__.py"
               for n in _defined(p)]


def _resolve(dotted: str):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _counterpart(module: str, name: str):
    key = f"{module}.{name}"
    if key in RENAMES:
        return _resolve(RENAMES[key])
    if name in ALIASES:
        return _resolve(ALIASES[name])
    port = MODULES.get(module, "tpu_cfd_torch" + module[len("tpu_cfd"):])
    return getattr(importlib.import_module(port), name)


@pytest.mark.parametrize("module,name", EXPORTS, ids=[f"{m}.{n}" for m, n in EXPORTS])
def test_each_exported_name_has_a_counterpart(module, name):
    """A name that a ``tpu_cfd`` package's ``__init__.py`` exports: the port's
    package of the same path exports it too, or ``RENAMES`` names its
    counterpart."""
    assert _counterpart(module, name) is not None


@pytest.mark.parametrize("module,name", DEFINITIONS,
                         ids=[f"{m}.{n}" for m, n in DEFINITIONS])
def test_each_defined_name_has_a_counterpart(module, name):
    """A public function, class or constant of a ``tpu_cfd`` module: the
    port's module of the same path (or ``MODULES``'s) has it, or ``RENAMES``
    or ``ALIASES`` names its counterpart."""
    assert _counterpart(module, name) is not None


def test_the_scan_found_the_package():
    """The AST scan sees the packages and modules it should (so that a
    moved file cannot empty the parametrisations above)."""
    packages = {m for m, _ in EXPORTS}
    assert {"tpu_cfd", "tpu_cfd.solvers", "tpu_cfd.models", "tpu_cfd.parallel",
            "tpu_cfd.utils"} <= packages
    assert len(EXPORTS) >= 60 and len(DEFINITIONS) >= 250
    assert ("tpu_cfd.ops.spectral", "spectral_div_2d") in DEFINITIONS
    assert ("tpu_cfd.solvers", "projection") in EXPORTS


def _velocity():
    """``tests/test_spectral_solver.py:48``'s inputs: the velocity spectra
    of a McWilliams vorticity at 64² (fp64) and the rfft mesh."""
    grid = jgrids.Grid((64, 64), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    w = jic.vorticity_field(jax.random.PRNGKey(0), grid, peak_wavenumber=4,
                            dtype=jnp.float64)
    (u_hat, v_hat), _ = jspectral.vorticity_to_velocity(grid, jnp.fft.rfft2(w.data))
    kx, ky = grid.rfft_mesh(dtype=jnp.float64)
    return [np.array(a) for a in (u_hat, v_hat, kx, ky)]


def test_spectral_div_2d_matches_jax():
    """2πi(kx û + ky v̂) on the divergence-free velocity of the JAX test (its
    divergence under 1e-10 in both) and on a velocity that is not
    divergence-free, against the JAX package's in fp64."""
    u_hat, v_hat, kx, ky = _velocity()
    rng = np.random.default_rng(0)
    noisy = [u_hat + rng.standard_normal(u_hat.shape) * np.abs(u_hat).max(),
             v_hat - rng.standard_normal(v_hat.shape) * np.abs(v_hat).max()]
    mesh_t = tuple(torch.from_numpy(k) for k in (kx, ky))
    for uv in ([u_hat, v_hat], noisy):
        want = np.asarray(jspectral.spectral_div_2d(tuple(jnp.asarray(a) for a in uv),
                                                    (jnp.asarray(kx), jnp.asarray(ky))))
        got = tspectral.spectral_div_2d(tuple(torch.from_numpy(a) for a in uv),
                                        mesh_t).numpy()
        assert got.dtype == np.complex128
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    div = np.fft.irfft2(tspectral.spectral_div_2d(
        (torch.from_numpy(u_hat), torch.from_numpy(v_hat)), mesh_t).numpy(), s=(64, 64))
    assert np.abs(div).max() < 1e-10


def test_spectral_div_2d_of_the_ports_velocity():
    """The port's own velocity from a vorticity (``vorticity_to_velocity``)
    is divergence-free to 1e-10 through ``spectral_div_2d``, as the JAX
    test holds JAX's."""
    grid = tgrids.Grid((64, 64), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    x = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    w = np.sin(3 * x)[:, None] * np.cos(2 * x)[None, :] + np.cos(x)[:, None]
    (u_hat, v_hat), _ = tspectral.vorticity_to_velocity(
        grid, torch.fft.rfft2(torch.from_numpy(w)))
    kx, ky = grid.rfft_mesh(dtype=torch.float64)
    div = torch.fft.irfft2(tspectral.spectral_div_2d((u_hat, v_hat), (kx, ky)), s=(64, 64))
    assert float(div.abs().max()) < 1e-10


def test_fft_expand_dims_matches_jax():
    """(x, y) meshes broadcast to (b, x, y, 1), as the JAX package's."""
    _, _, kx, ky = _velocity()
    want = jspectral.fft_expand_dims((jnp.asarray(kx), jnp.asarray(ky)), 3)
    got = tspectral.fft_expand_dims((torch.from_numpy(kx), torch.from_numpy(ky)), 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (3, 64, 33, 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
