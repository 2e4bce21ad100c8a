"""The port's four examples end to end on the CPU at small sizes.

``ex1_kolmogorov_simulation`` at 32², ``ex1_kolmogorov_fvm`` at 32² in fp64
(max |div| < 1e-12, the FVM contract), ``check_sfno_shapes`` at a reduced
width (its output shapes and named latents against the JAX model's for the
same inputs), and ``ex2_sfno_5ep_spectra`` for one epoch on a 32² dataset
that the port's CLI writes; each with its figures under the Agg backend.
"""

import os

import jax
import matplotlib
import numpy as np
import pytest
import torch

from tpu_cfd.models import SFNO as JaxSFNO
from tpu_cfd.models.base import apply_with_latents
from tpu_cfd_torch.data import generate
from tpu_cfd_torch.examples import (check_sfno_shapes, ex1_kolmogorov_fvm,
                                    ex1_kolmogorov_simulation, ex2_sfno_5ep_spectra)
from tpu_cfd_torch.models import forward_with_latents

matplotlib.use("Agg")
torch.set_num_threads(2)


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_kolmogorov_simulation(tmp_path):
    out = ex1_kolmogorov_simulation.main(
        ["--n", "32", "--steps", "30", "--no-cuda", "--out", str(tmp_path / "kol")])
    assert out["trajectory"].shape == (10, 32, 32)
    assert np.isfinite(out["trajectory"]).all() and np.isfinite(out["enstrophy"])
    assert out["spectrum"].shape == (32 // 2 - 1,)
    assert out["spectrum"].sum() == pytest.approx(1.0)
    assert out["figures"] == [str(tmp_path / "kol_snapshots.png"),
                              str(tmp_path / "kol_spectrum.png")]
    assert all(_is_png(f) for f in out["figures"])


def test_kolmogorov_fvm_fp64_divergence_free(tmp_path):
    out = ex1_kolmogorov_fvm.main(["--n", "32", "--frames", "2", "--no-cuda",
                                   "--out", str(tmp_path / "fvm.png")])
    assert out["frames"].shape == (2, 32, 32) and out["frames"].dtype == np.float64
    assert np.isfinite(out["frames"]).all()
    assert out["max_div"] < 1e-12
    assert _is_png(out["figure"])


def test_check_sfno_shapes_match_jax():
    """Output shapes of the example's sweep (without 256², which the slow
    test below runs) and its named latents, against the JAX SFNO of the
    same configuration at width 4."""
    width = 4
    model = check_sfno_shapes.build(width)
    gen = torch.Generator().manual_seed(0)
    shapes = [s for s in check_sfno_shapes.SHAPES if s[0] < 256]
    got = check_sfno_shapes.output_shapes(model, shapes, "cpu", gen)
    jmodel = JaxSFNO(modes_x=16, modes_y=16, modes_t=5, width=width, latent_steps=10,
                     num_spectral_layers=4)
    rng = np.random.default_rng(0)
    v64 = rng.standard_normal((2, 64, 64, 10)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), v64)
    for n, t_in, t_out in shapes:
        v = rng.standard_normal((1, n, n, t_in)).astype(np.float32)
        want = jmodel.apply(params, v, out_steps=t_out).shape
        assert got[(n, t_in, t_out)] == tuple(want), (n, t_in, t_out)
    _, jlatents = apply_with_latents(jmodel, params, v64)
    with torch.no_grad():
        _, latents = forward_with_latents(model, torch.from_numpy(v64))
    assert {k: tuple(v.shape) for k, v in latents.items()} == {
        k: tuple(v.shape) for k, v in jlatents.items()}


@pytest.mark.slow
def test_check_sfno_shapes_main():
    out = check_sfno_shapes.main(["--width", "4", "--iters", "2", "--no-cuda"])
    assert out["shapes"][(256, 10, 10)] == (1, 256, 256, 10)
    assert len(out["latents"]) == 5 and out["ms_per_forward"] > 0
    assert len(out["forwards"]) == len(check_sfno_shapes.SHAPES) + 1 + 3


def test_sfno_5ep_spectra_one_epoch(tmp_path):
    data = generate.main_mcwilliams([
        "--no-cuda", "--grid-size", "32", "--subsample", "1", "--num-samples", "12",
        "--batch-size", "6", "--time", "0.05", "--time-warmup", "0.01", "--dt", "1e-3",
        "--num-steps", "25", "--filepath", str(tmp_path)])
    out = ex2_sfno_5ep_spectra.main(
        ["--epochs", "1", "--num-samples", "8", "--num-val-samples", "4",
         "--data-file", data, "--no-cuda", "--out", str(tmp_path / "spec.png")])
    assert out["n"] == 32 and out["train_steps"] == 2
    assert np.isfinite(out["gap"]) and np.isfinite(out["history"]).all()
    assert os.path.exists(out["figure"]) and _is_png(out["figure"])
