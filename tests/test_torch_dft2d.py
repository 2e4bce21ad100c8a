"""The port's dense-DFT transforms and host matrices against the JAX package.

Both packages get the same numpy inputs. Matrices must be equal bit for bit
(both build them in float64 with numpy, then cast). Transforms are held to
the JAX suite's fp64 tolerance (rtol 1e-10, tests/test_spectral_solver.py)
and, in fp32, to 2e-6 of the largest output magnitude (sums of n fp32
products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cfd.ops import dft2d as jdft
from tpu_cfd_torch import convert
from tpu_cfd_torch.ops import dft2d as tdft

torch.set_num_threads(2)

FP32_TOL = 2e-6


def _rng_field(shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("n,m", [(12, 7), (32, 17), (32, 16), (48, 21)])
@pytest.mark.parametrize("dtype_str", ["float32", "float64"])
def test_mats_equal_jax(n, m, dtype_str):
    ours, ref = tdft._mats(n, m, dtype_str), jdft._mats(n, m, dtype_str)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("n", [12, 32, 64, 256])
def test_galerkin_block_and_rows_equal_jax(n):
    rows, m = tdft.galerkin_block(n)
    assert (rows, m) == jdft.galerkin_block(n)
    assert rows[0] == 0
    for dtype_str in ("float32", "float64"):
        ours, ref = tdft._mats_rows(n, rows, dtype_str), jdft._mats_rows(n, rows, dtype_str)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("m", [None, 16])
def test_rfft2_matmul_fp64_matches_numpy_and_jax(m):
    x = _rng_field((3, 32, 32), np.float64)
    ours = tdft.rfft2_matmul(torch.from_numpy(x), m=m).numpy()
    ref = np.fft.rfft2(x)[..., : (m or 17)]
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        ours, np.asarray(jdft.rfft2_matmul(jnp.asarray(x), m=m)), rtol=1e-10,
        atol=1e-10)


@pytest.mark.parametrize("m", [17, 16])
def test_irfft2_matmul_fp64_matches_numpy_and_jax(m):
    X = np.fft.rfft2(_rng_field((2, 32, 32), np.float64, 1))[..., :m]
    ours = tdft.irfft2_matmul(torch.from_numpy(X)).numpy()
    full = np.zeros((2, 32, 17), complex)
    full[..., :m] = X
    np.testing.assert_allclose(ours, np.fft.irfft2(full, s=(32, 32)), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(jdft.irfft2_matmul(jnp.asarray(X))),
                               rtol=1e-10, atol=1e-12)


def test_fp32_transforms_match_torch_fft():
    x = _rng_field((4, 64, 64), np.float32, 2)
    ours = tdft.rfft2_matmul(torch.from_numpy(x))
    ref = torch.fft.rfft2(torch.from_numpy(x.astype(np.float64)))
    assert ours.dtype == torch.complex64
    err = (ours.to(torch.complex128) - ref).abs().max() / ref.abs().max()
    assert float(err) < FP32_TOL
    back = tdft.irfft2_matmul(ours)
    assert float((back - torch.from_numpy(x)).abs().max()) < FP32_TOL * np.abs(x).max() * 10


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_transforms_match_jax(dtype):
    n = 32
    rows, m = tdft.galerkin_block(n)
    x = _rng_field((2, n, n), dtype, 3)
    ours = tdft.rfft2_block(torch.from_numpy(x), rows, m).numpy()
    ref = np.asarray(jdft.rfft2_block(jnp.asarray(x), rows, m))
    tol = 1e-10 if dtype == np.float64 else FP32_TOL
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * np.abs(ref).max())
    # the block equals the full transform restricted to its modes
    full = np.fft.rfft2(x.astype(np.float64))[..., list(rows), :m]
    np.testing.assert_allclose(ours, full, rtol=0, atol=tol * np.abs(full).max())
    inv = tdft.irfft2_block(torch.from_numpy(ours), n, rows).numpy()
    inv_ref = np.asarray(jdft.irfft2_block(jnp.asarray(ours), n, rows))
    np.testing.assert_allclose(inv, inv_ref, rtol=0, atol=tol * np.abs(inv_ref).max())


def test_precision_strings():
    x = torch.zeros(8, 8)
    for p in tdft.PRECISIONS:
        tdft.rfft2_matmul(x, precision=p)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError, match="precision"):
        tdft.rfft2_matmul(x, precision="tf32")


def test_convert_round_trips():
    spec = (_rng_field((2, 8, 5), np.float32) + 1j * _rng_field((2, 8, 5), np.float32, 1)
            ).astype(np.complex64)
    t = convert.spectrum_from_numpy(spec, "cpu")
    assert t.dtype == torch.complex64
    np.testing.assert_array_equal(convert.spectrum_to_numpy(t), spec)
    field = _rng_field((3, 8, 8), np.float64)
    f = convert.field_from_numpy(field, "cpu")
    assert f.dtype == torch.float64
    np.testing.assert_array_equal(convert.field_to_numpy(f), field)
    with pytest.raises(ValueError):
        convert.spectrum_from_numpy(field, "cpu")
    with pytest.raises(ValueError):
        convert.field_from_numpy(spec, "cpu")
