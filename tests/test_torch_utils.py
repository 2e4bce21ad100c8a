"""The port's utilities (``tpu_cfd_torch.utils``) against the JAX package's.

The enstrophy spectrum to rtol 1e-12 of JAX's on the same seeded fields,
and the JAX suite's two physics checks on the port's function and solver;
the parameter count of a small SFNO equal to JAX's count of the same
model's flax parameters; the timer, the NaN check, ``clones``, the profiler
trace, the live-tensor summary and the plots (Agg backend) on the CPU.
"""

import glob
import json
import math
import os

import jax
import matplotlib
import numpy as np
import pytest
import torch

from tpu_cfd.models import SFNO as JaxSFNO
from tpu_cfd.utils import get_num_params as jax_num_params
from tpu_cfd.utils import visualizations as jviz
from tpu_cfd_torch import convert, grids
from tpu_cfd_torch.models import SFNO
from tpu_cfd_torch.solvers import equations, initial_conditions as ic
from tpu_cfd_torch.utils import (check_nan, clones, device_memory_summary, get_config,
                                 get_num_params, get_seed, get_size, profile_to, timer,
                                 trace_annotation)
from tpu_cfd_torch.utils import visualizations as viz

matplotlib.use("Agg")
torch.set_num_threads(2)


@pytest.mark.parametrize("n,h", [(32, 2 * np.pi / 32), (64, 1 / 64), (48, 0.1)])
def test_enstrophy_spectrum_matches_jax(n, h):
    w = np.random.default_rng(n).standard_normal((n, n))
    want = jviz.get_enstrophy_spectrum(w, h)
    got = viz.get_enstrophy_spectrum(w, h)
    assert got.shape == (n // 2 - 1,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_single_mode_lands_in_right_shell():
    n = 64
    h = 2 * np.pi / n
    x, _ = np.meshgrid(np.arange(n) * h, np.arange(n) * h, indexing="ij")
    assert viz.get_enstrophy_spectrum(np.sin(5 * x), h).argmax() + 1 == 5


def test_mcwilliams_inverse_cascade_shape():
    """The port's solver and spectrum: peak at low k, the tail orders of
    magnitude below (tests/test_data_train.py:484-505)."""
    n = 128
    grid = grids.Grid((n, n), domain=((0, 2 * np.pi), (0, 2 * np.pi)))
    noise = torch.randn(grid.shape, generator=torch.Generator().manual_seed(0))
    w0 = ic.vorticity_field(grid, 4, noise=noise).data
    ns = equations.NavierStokes2DSpectral(viscosity=1e-3, grid=grid, device="cpu")
    with torch.no_grad():
        what, _ = ns.forward(torch.fft.rfft2(w0), 1e-3, steps=500)
    w = torch.fft.irfft2(what, s=(n, n)).numpy()
    E = viz.get_enstrophy_spectrum(w, 2 * np.pi / n)
    assert E.argmax() + 1 <= 8, E.argmax() + 1
    assert E.max() > 1e3 * max(E[40:50].mean(), 1e-300)


def test_num_params_matches_jax():
    """A small SFNO: flax's parameters counted by JAX's get_num_params, and
    the port's model holding them (convert.py) counted by the port's."""
    kw = dict(modes_x=4, modes_y=4, modes_t=3, width=6, latent_steps=4,
              num_spectral_layers=3, output_steps=4)
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 4)).astype(np.float32)
    params = JaxSFNO(**kw).init(jax.random.PRNGKey(0), x)
    model = SFNO(**kw)
    model.load_state_dict(convert.sfno_state_dict_from_flax(params))
    assert get_num_params(model) == jax_num_params(params)
    assert get_num_params(dict(model.named_parameters())) == jax_num_params(params)
    assert get_num_params([torch.zeros(3, dtype=torch.complex64)]) == 6
    assert get_size(model) == pytest.approx(4 * get_num_params(model) / 2 ** 20)


def test_seed_timer_nan_clones_config(capsys):
    g = get_seed(3, printout=False)
    assert torch.equal(torch.randn(4, generator=g),
                       torch.randn(4, generator=torch.Generator().manual_seed(3)))
    assert np.random.rand() == np.random.RandomState(3).rand()
    with timer("work", verbose=True) as t:
        sum(range(10 ** 5))
    assert isinstance(t["seconds"], float) and t["seconds"] > 0
    assert "[timer] work:" in capsys.readouterr().out
    check_nan(torch.ones(3))
    with pytest.raises(ValueError, match="NaN detected in field"):
        check_nan(torch.tensor([1.0, math.nan]), "field")
    layers = clones(torch.nn.Linear(2, 2), 3)
    assert len(layers) == 3 and layers[0].weight is not layers[1].weight
    assert torch.equal(layers[0].weight, layers[2].weight)

    class Cfg:
        def __init__(self):
            self.a, self.b, self._c, self.d = 1, "x", 2, [1]

    assert get_config(Cfg()) == {"a": 1, "b": "x"}


def test_profile_to_writes_trace(tmp_path):
    with profile_to(str(tmp_path / "trace")) as d:
        with trace_annotation("smoke"):
            torch.ones((8, 8)) * 2
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "smoke" in names


def test_device_memory_summary_lists_a_new_tensor():
    keep = torch.ones((123, 7), dtype=torch.float64)
    s = device_memory_summary("cpu")
    assert "torch.float64" in s and "(123, 7)" in s
    assert "total" in s and "MB" in s
    del keep


def test_plots_write_png(tmp_path):
    rng = np.random.default_rng(1)
    traj = rng.standard_normal((6, 32, 32))
    paths = [viz.save_figure(lambda: viz.plot_contour_trajectory(traj, num_snapshots=3),
                             str(tmp_path / "traj.png")),
             viz.save_figure(lambda: viz.plot_enstrophy_spectrum(
                 [traj[0], traj[-1]], h=2 * np.pi / 32, labels=["a", "b"], title="t"),
                 str(tmp_path / "spec.png"))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_save_figure_without_matplotlib(tmp_path, monkeypatch, capsys):
    """A missing matplotlib, and only that, is one line and no figure."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    path = str(tmp_path / "x.png")
    assert viz.save_figure(lambda: 1 / 0, path) is None
    assert capsys.readouterr().out.strip() == (f"no figure written to {path}: "
                                               "matplotlib is not installed")
    assert not os.path.exists(path)
    monkeypatch.setattr(builtins, "__import__", real_import)
    with pytest.raises(ZeroDivisionError):
        viz.save_figure(lambda: 1 / 0, path)
