"""The port's GRF2d sampler against the JAX package.

JAX draws its noise inside ``GRF2d.sample`` with ``jax.random.normal(key,
(bsz, 2, n0, n0))``; the test draws the same noise and hands it to the port
as ``noise=``. ``sqrt_eig`` holds to rel 1e-12 in fp64 and 1e-6 in fp32;
samples to 1e-12 (fp64) and 1e-5 (fp32) of their largest magnitude; the
smoothed path (noise at ``max_mesh_size``² resized to n²) to the tolerance
of ``test_subsample_matches_jax_image_resize`` (1e-12 fp64, 1e-6 fp32).
Samples drawn from generators have the spectrum ``sqrt_eig²``: E|ŝ_k|² =
sqrt_eig_k² for every mode, since ŝ_k = (c_k + conj(c_-k))/2 for the
complex coefficients c = sqrt_eig·(a + ib).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd.data.grf import GRF2d as JaxGRF2d
from tpu_cfd_torch.data.grf import GRF2d
from tpu_cfd_torch.solvers import initial_conditions as tic

torch.set_num_threads(2)

DTYPES = {"fp64": (jnp.float64, torch.float64), "fp32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dtype", ["fp64", "fp32"])
@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("alpha,tau", [(2.5, 7.0), (2.0, 3.0)])
def test_sqrt_eig_matches_jax(dtype, n, alpha, tau):
    jd, td = DTYPES[dtype]
    ref = np.asarray(JaxGRF2d(n=n, alpha=alpha, tau=tau, dtype=jd).sqrt_eig())
    ours = GRF2d(n=n, alpha=alpha, tau=tau, dtype=td).sqrt_eig()
    assert ours.dtype == td and tuple(ours.shape) == (n, n) and float(ours[0, 0]) == 0.0
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-12 if dtype == "fp64" else 1e-6,
                               atol=0)


@pytest.mark.parametrize("dtype", ["fp64", "fp32"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("n,bsz", [(32, 3), (64, 1)])
def test_sample_matches_jax_on_shared_noise(dtype, normalize, n, bsz):
    jd, td = DTYPES[dtype]
    key = jax.random.PRNGKey(n + bsz)
    noise = np.array(jax.random.normal(key, (bsz, 2, n, n), dtype=jd))
    ref = np.asarray(JaxGRF2d(n=n, alpha=2.5, tau=7.0, normalize=normalize, dtype=jd)
                     .sample(key, bsz=bsz))
    grf = GRF2d(n=n, alpha=2.5, tau=7.0, normalize=normalize, dtype=td)
    ours = grf.sample(noise=torch.from_numpy(noise), bsz=bsz)
    assert ours.dtype == td and tuple(ours.shape) == (bsz, n, n)
    tol = 1e-12 if dtype == "fp64" else 1e-5
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    np.testing.assert_array_equal(grf(noise=torch.from_numpy(noise)).numpy(), ours.numpy())


@pytest.mark.parametrize("dtype", ["fp64", "fp32"])
@pytest.mark.parametrize("n", [16, 32])
def test_smoothed_sample_matches_jax_image_resize(dtype, n):
    jd, td = DTYPES[dtype]
    key = jax.random.PRNGKey(n)
    noise = np.array(jax.random.normal(key, (2, 2, 64, 64), dtype=jd))
    ref = np.asarray(JaxGRF2d(n=n, smoothing=True, max_mesh_size=64, dtype=jd)
                     .sample(key, bsz=2))
    ours = GRF2d(n=n, smoothing=True, max_mesh_size=64, dtype=td).sample(
        noise=torch.from_numpy(noise), bsz=2)
    tol = 1e-12 if dtype == "fp64" else 1e-6
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    with pytest.raises(ValueError, match="does not end with"):
        GRF2d(n=n, smoothing=True, max_mesh_size=64).sample(noise=torch.zeros(1, 2, n, n))


def test_generator_samples_have_the_covariance_spectrum():
    """64 samples at 32²: the mean of |ŝ_k|² over samples against
    sqrt_eig_k² on the modes 0 < |k| ≤ 4. Each shell of |k| (rounded) lies
    within ±25 %; a single mode is the mean of 64 exponential draws (a
    relative spread of 1/8), so each lies within 0.5 to 1.6 (four spreads)."""
    n, count = 32, 64
    grf = GRF2d(n=n, alpha=2.5, tau=7.0, dtype=torch.float64)
    s = torch.cat([grf.sample(tic.sample_generator(5, i), bsz=1) for i in range(count)])
    power = (torch.fft.fft2(s).abs() ** 2).mean(dim=0)
    ratio = (power / grf.sqrt_eig() ** 2).numpy()
    k = np.fft.fftfreq(n, d=1.0 / n)
    kk = np.sqrt(k[:, None] ** 2 + k[None, :] ** 2)
    modes = (kk > 0) & (kk <= 4)
    assert modes.sum() == 48
    assert ((ratio[modes] > 0.5) & (ratio[modes] < 1.6)).all(), ratio[modes]
    for shell in range(1, 5):
        in_shell = modes & (np.rint(kk) == shell)
        assert abs(ratio[in_shell].mean() - 1) < 0.25, (shell, ratio[in_shell])


def test_generator_draws_are_per_sample_and_stable():
    grf = GRF2d(n=16, dtype=torch.float32)
    a = grf.sample(tic.sample_generator(3, 0), bsz=2)
    g = tic.sample_generator(3, 0)
    b = torch.cat([grf.sample(g, bsz=1), grf.sample(g, bsz=1)])
    assert torch.equal(a, b)  # one generator, draws in order
    assert torch.equal(grf.sample(tic.sample_generator(3, 1)),
                       grf.sample(tic.sample_generator(3, 1)))
    assert not torch.equal(a[:1], grf.sample(tic.sample_generator(3, 1)))
    smooth = GRF2d(n=16, smoothing=True, max_mesh_size=64)
    x = smooth.sample(tic.sample_generator(3, 0))
    assert tuple(x.shape) == (1, 16, 16) and torch.isfinite(x).all()
    with pytest.raises(ValueError, match="generator or a noise"):
        grf.sample()
