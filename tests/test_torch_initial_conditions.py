"""The port's initial conditions against the JAX package: the McWilliams
vorticity and the filtered divergence-free velocity.

JAX draws its noise inside ``vorticity_field`` with
``jax.random.normal(key, grid.shape)`` (and inside
``filtered_velocity_field`` one draw per component); the port takes that
same noise through ``noise=``. fp32 fields are held to 2e-4 of their largest
magnitude: on these inputs either package's fp32 field lies within about
4e-5 of the fp64 field (k² amplifies the FFT roundoff), so they may differ
by twice that; fp64 fields to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd import boundaries as jboundaries, grids as jgrids
from tpu_cfd.ops import finite_differences as jfdm
from tpu_cfd.solvers import initial_conditions as jic
from tpu_cfd_torch import boundaries as tboundaries, grids as tgrids
from tpu_cfd_torch.ops import finite_differences as tfdm
from tpu_cfd_torch.solvers import initial_conditions as tic

torch.set_num_threads(2)

DOMAIN = ((0, 2 * np.pi), (0, 2 * np.pi))


def _grids(n):
    return jgrids.Grid((n, n), domain=DOMAIN), tgrids.Grid((n, n), domain=DOMAIN)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("peak", [3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_vorticity_field_matches_jax_on_shared_noise(n, peak, seed):
    jg, tg = _grids(n)
    key = jax.random.PRNGKey(seed)
    noise = np.array(jax.random.normal(key, jg.shape, dtype=jnp.float32))
    ref = np.asarray(jic.vorticity_field(key, jg, peak, dtype=jnp.float32).data)
    ours = tic.vorticity_field(tg, peak, noise=torch.from_numpy(noise), device="cpu")
    assert ours.data.dtype == torch.float32 and tuple(ours.data.shape) == (n, n)
    assert ours.offset == (0.5, 0.5) and ours.bc.types == (("periodic",) * 2,) * 2
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours.data.numpy(), ref, rtol=0, atol=2e-4 * scale)
    exact = tic.vorticity_field(tg, peak, dtype=torch.float64,
                                noise=torch.from_numpy(noise.astype(np.float64)))
    np.testing.assert_allclose(ours.data.numpy(), exact.data.numpy(), rtol=0,
                               atol=1e-4 * scale)


def test_vorticity_field_fp64_matches_jax():
    jg, tg = _grids(32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, jg.shape, dtype=jnp.float64))
    ref = np.asarray(jic.vorticity_field(key, jg, 4, dtype=jnp.float64).data)
    ours = tic.vorticity_field(tg, 4, dtype=torch.float64,
                               noise=torch.from_numpy(noise)).data.numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_spectral_pieces_match_jax():
    jg, tg = _grids(32)
    kj = np.asarray(jic._angular_frequency_magnitude(jg, dtype=jnp.float64))
    kt = tic._angular_frequency_magnitude(tg, dtype=torch.float64)
    np.testing.assert_allclose(kt.numpy(), kj, rtol=1e-15)
    k = np.linspace(0.5, 20.0, 50)
    np.testing.assert_allclose(
        tic.McWilliams_density(torch.from_numpy(k), 4.0).numpy(),
        np.asarray(jic.McWilliams_density(jnp.asarray(k), 4.0)), rtol=1e-14)
    psi = np.random.default_rng(0).standard_normal((32, 32))
    np.testing.assert_allclose(
        tic.streamfunc_normalize(kt, torch.from_numpy(psi)).numpy(),
        np.asarray(jic.streamfunc_normalize(jnp.asarray(kj), jnp.asarray(psi))),
        rtol=1e-12)
    dens = lambda kk: jic.McWilliams_density(kk, 3)  # noqa: E731
    np.testing.assert_allclose(
        tic.spectral_filter(lambda kk: tic.McWilliams_density(kk, 3),
                            torch.from_numpy(psi), tg).numpy(),
        np.asarray(jic.spectral_filter(dens, jnp.asarray(psi), jg)),
        rtol=0, atol=1e-12)


def test_batched_noise_equals_per_sample():
    _, tg = _grids(32)
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 32, 32)))
    batched = tic.vorticity_field(tg, 4, dtype=torch.float64, noise=noise).data
    for i in range(3):
        single = tic.vorticity_field(tg, 4, dtype=torch.float64, noise=noise[i]).data
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(), rtol=1e-13,
                                   atol=1e-13)


def test_sample_generators_are_deterministic_and_resume_stable():
    _, tg = _grids(16)

    def draw(ids):
        return torch.stack([
            tic.vorticity_field(tg, 4, generator=tic.sample_generator(7, i)).data
            for i in ids])

    full = draw(range(4))
    resumed = torch.cat([draw(range(2)), draw(range(2, 4))])
    assert torch.equal(full, resumed)
    assert torch.equal(draw([1]), draw([1]))
    assert not torch.equal(draw([1]), draw([2]))
    assert not torch.equal(
        tic.vorticity_field(tg, 4, generator=tic.sample_generator(8, 1)).data, draw([1])[0])
    with pytest.raises(ValueError, match="generator or a noise"):
        tic.vorticity_field(tg, 4)


def _velocity_noise(keys, grid_j, dtype):
    """JAX's noise of ``filtered_velocity_field``: one draw per component from
    ``jax.random.split(key, ndim)``, for each key."""
    return np.stack([
        np.stack([np.array(jax.random.normal(k, grid_j.shape, dtype=dtype))
                  for k in jax.random.split(key, grid_j.ndim)])
        for key in keys])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n,peak", [(32, 4), (64, 2)])
def test_filtered_velocity_field_matches_jax_on_shared_noise(batch, n, peak):
    """fp64, 1e-10 of the largest speed; each sample's maximum speed is the
    maximum velocity. At b=4 a batch-wide maximum would scale three of the
    four samples below it."""
    jg, tg = _grids(n)
    keys = jax.random.split(jax.random.PRNGKey(n + batch), batch)
    noise = _velocity_noise(keys, jg, jnp.float64)
    ref = [jic.filtered_velocity_field(k, jg, maximum_velocity=5.0, peak_wavenumber=peak,
                                       dtype=jnp.float64) for k in keys]
    ours = tic.filtered_velocity_field(tg, maximum_velocity=5.0, peak_wavenumber=peak,
                                       dtype=torch.float64, noise=torch.from_numpy(noise))
    assert isinstance(ours, tgrids.GridVariableVector) and len(ours) == 2
    for c, u in enumerate(ours):
        assert u.offset == tg.cell_faces[c] and tuple(u.data.shape) == (batch, n, n)
        want = np.stack([np.asarray(r[c].data) for r in ref])
        np.testing.assert_allclose(u.data.numpy(), want, rtol=0, atol=1e-10 * 5.0)
    speed = torch.linalg.vector_norm(torch.stack([u.data for u in ours]), dim=0)
    np.testing.assert_allclose(speed.amax(dim=(-2, -1)).numpy(), 5.0, rtol=1e-12)
    curl_ref = np.stack([np.asarray(jfdm.curl_2d(r).data) for r in ref])
    curl = tfdm.curl_2d(ours)
    assert curl.offset == (1.0, 1.0)
    np.testing.assert_allclose(curl.data.numpy(), curl_ref, rtol=0,
                               atol=1e-10 * np.abs(curl_ref).max())


def test_filtered_velocity_field_fp32_is_divergence_free():
    _, tg = _grids(32)
    v = tic.filtered_velocity_field(tg, maximum_velocity=5.0, peak_wavenumber=4,
                                    generator=tic.sample_generator(1, 0))
    assert v[0].data.dtype == torch.float32
    assert float(tfdm.divergence(v).data.abs().max()) < 1e-4
    speed = torch.linalg.vector_norm(torch.stack([u.data for u in v]), dim=0)
    assert abs(float(speed.max()) - 5.0) < 5e-5
    # one generator, the components in order: the batched noise of the CLI
    g = tic.sample_generator(1, 0)
    noise = torch.randn((2, 32, 32), generator=g)
    again = tic.filtered_velocity_field(tg, maximum_velocity=5.0, peak_wavenumber=4,
                                        noise=noise)
    assert all(torch.equal(a.data, b.data) for a, b in zip(v, again))
    with pytest.raises(ValueError, match="generator or a noise"):
        tic.filtered_velocity_field(tg)
    with pytest.raises(ValueError, match="does not end with"):
        tic.filtered_velocity_field(tg, noise=torch.zeros(3, 32, 32))


def test_velocity_pieces_match_jax():
    jg, tg = _grids(32)
    k = np.linspace(0.5, 20.0, 50)
    np.testing.assert_allclose(
        tic._log_normal_density(torch.from_numpy(k), 4.0).numpy(),
        np.asarray(jic._log_normal_density(jnp.asarray(k), 4.0)), rtol=1e-13)
    data = [np.random.default_rng(s).standard_normal((32, 32)) for s in (1, 2)]
    tbc = tboundaries.periodic_boundary_conditions(2)
    jbc = jboundaries.periodic_boundary_conditions(2)
    tv = tic.wrap_velocities([torch.from_numpy(d) for d in data], tg, [tbc, tbc])
    jv = jic.wrap_velocities([jnp.asarray(d) for d in data], jg, [jbc, jbc])
    assert [u.offset for u in tv] == [tuple(u.offset) for u in jv]
    for a, b in zip(tic.project_and_normalize(tv, 2.0), jic.project_and_normalize(jv, 2.0)):
        np.testing.assert_allclose(a.data.numpy(), np.asarray(b.data), rtol=0, atol=1e-12)
