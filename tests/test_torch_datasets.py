"""The port's normalizers and FNO-baseline datasets (data/datasets.py) vs JAX's.

The same numpy arrays go through the classes of ``tpu_cfd.data.datasets`` and
their copies in the port: values to 1e-6 of the largest reference entry (the
port resamples the statistics with its own linear resize instead of
``jax.image.resize``; everything else is the same numpy arithmetic).
"""

import numpy as np
import pytest
import scipy.io as sio

from tpu_cfd.data import datasets as jd
from tpu_cfd_torch.data import datasets as td


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _data(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return (1.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("cls", ["UnitGaussianNormalizer", "SpatialGaussianNormalizer"])
def test_normalizers_match_jax(cls):
    x = _data(12, 8, 8, 5)
    jn, tn = getattr(jd, cls)(), getattr(td, cls)()
    assert _rel_err(tn.fit_transform(x), jn.fit_transform(x)) < 1e-6
    assert tn.mean.shape == jn.mean.shape and tn.mean.dtype == np.float32
    assert _rel_err(tn.mean, jn.mean) < 1e-6 and _rel_err(tn.std, jn.std) < 1e-6
    y = _data(3, 8, 8, 5, seed=1)
    assert _rel_err(tn.transform(y), jn.transform(y)) < 1e-6
    assert _rel_err(tn.inverse_transform(y), jn.inverse_transform(y)) < 1e-6
    # an unfitted normalizer passes its input through
    assert getattr(td, cls)().transform(y) is y


@pytest.mark.parametrize("size", [(16, 16, 5), (4, 4, 5), (12, 6, 9)], ids=str)
def test_normalizer_aligns_to_another_resolution(size):
    x = _data(12, 8, 8, 5)
    jn, tn = jd.UnitGaussianNormalizer(data=x), td.UnitGaussianNormalizer(data=x)
    y = _data(3, *size, seed=2)
    assert _rel_err(tn.transform(y, align_shapes=True),
                    jn.transform(y, align_shapes=True)) < 1e-6
    assert _rel_err(tn.inverse_transform(y), jn.inverse_transform(y)) < 1e-6
    with pytest.raises(ValueError, match="dimensions"):
        td.resize_linear(x[0], (4, 4))


def test_normalizer_save_and_load(tmp_path):
    x = _data(6, 8, 8, 4)
    tn = td.SpatialGaussianNormalizer(eps=1e-5, data=x)
    tn.save(tmp_path / "norm.npz")
    for module in (td, jd):  # either package reads the file
        back = module.UnitGaussianNormalizer.load(tmp_path / "norm.npz")
        assert back.eps == pytest.approx(1e-5)
        assert np.array_equal(back.mean, tn.mean) and np.array_equal(back.std, tn.std)
    y = _data(2, 8, 8, 4, seed=3)
    assert np.array_equal(td.UnitGaussianNormalizer.load(tmp_path / "norm.npz")
                          .transform(y), tn.transform(y))


@pytest.mark.parametrize("train", [True, False])
def test_fixed_time_dataset_matches_jax(train):
    data = {"vorticity": _data(9, 30, 8, 8)}
    kw = dict(n_samples=7, fields=["vorticity"], steps=4, out_steps=3, T_start=5,
              train=train)
    jds = jd.SpatioTemporalDatasetFixedTime(dict(data), **kw)
    tds = td.SpatioTemporalDatasetFixedTime(dict(data), **kw)
    assert _rel_err(tds.data["vorticity"], jds.data["vorticity"]) < 1e-6
    jn, tn = jds.normalizers["vorticity"], tds.normalizers["vorticity"]
    assert tn.mean.shape == (8, 8, 1) and _rel_err(tn.std, jn.std) < 1e-6
    (jin, jout), (tin, tout) = (ds.sample(np.arange(3)) for ds in (jds, tds))
    assert np.array_equal(jin["time_steps"], tin["time_steps"])
    assert tin["time_steps"][0, 0] == 5 and tout["time_steps"][0, 0] == 9
    assert _rel_err(tin["vorticity"], jin["vorticity"]) < 1e-6
    assert _rel_err(tout["vorticity"], jout["vorticity"]) < 1e-6
    raw = td.SpatioTemporalDatasetFixedTime(dict(data), normalize=False, **kw)
    assert raw.normalizers == {} and raw.data["vorticity"].dtype == np.float32


@pytest.mark.parametrize("train,subsample", [(True, 1), (False, 1), (True, 2)])
def test_navier_stokes_dataset_matches_jax(tmp_path, train, subsample):
    u = _data(10, 16, 16, 12, seed=4)
    npz, mat = tmp_path / "ns.npz", tmp_path / "ns.mat"
    np.savez(npz, u=u)
    sio.savemat(mat, {"u": u})
    kw = dict(n_samples=6, train=train, time_steps_input=5, time_steps_output=4,
              subsample=subsample)
    jds = jd.NavierStokesDataset(npz, **kw)
    for path in (npz, mat):
        tds = td.NavierStokesDataset(path, **kw)
        assert len(tds) == len(jds) == 6
        assert tds.a.shape == (6, 16 // subsample, 16 // subsample, 5)
        assert _rel_err(tds.a, jds.a) < 1e-6 and np.array_equal(tds.u, jds.u)
        assert _rel_err(tds.normalizer.mean, jds.normalizer.mean) < 1e-6
    jb = list(jds.batches(4, np.random.default_rng(7)))
    tb = list(tds.batches(4, np.random.default_rng(7)))
    assert len(jb) == len(tb) == 1
    assert _rel_err(tb[0]["a"], jb[0]["a"]) < 1e-6 and np.array_equal(tb[0]["u"], jb[0]["u"])
    assert td.NavierStokesDataset(npz, normalize=False, **kw).normalizer is None


def test_unsupported_format_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported data format"):
        td.load_trajectory_dict(tmp_path / "x.csv")
