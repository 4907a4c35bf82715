"""In-repository field generator (st_dadk_tpu/dataio/synth.py)."""
import numpy as np
import pytest

from st_dadk_tpu.dataio import synth
from st_dadk_tpu.dataio.kaust import load_kaust_csv_single


@pytest.fixture(scope="module")
def params():
    return synth.load_fit_params()


def test_deterministic_from_seed(params):
    sites = synth.uniform_sites(60, seed=4)
    a = synth.synthesize(sites, 7, params, seed=4)
    b = synth.synthesize(sites, 7, params, seed=4)
    c = synth.synthesize(sites, 7, params, seed=5)
    assert a.shape == (7, 60) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    np.testing.assert_array_equal(synth.uniform_sites(60, 4), sites)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_statistics_match_fit_params(params, seed):
    """Stationary separable field: variance std^2 (sigma2 + nugget), mean
    `mean`, lag-1 temporal autocorrelation phi_t."""
    sites = synth.uniform_sites(300, seed)
    z = synth.synthesize(sites, 80, params, seed).astype(np.float64)
    var = params["std"] ** 2 * (params["sigma2"] + params["nugget"])
    assert z.var() == pytest.approx(var, rel=0.15)
    assert abs(z.mean() - params["mean"]) < 0.25 * params["std"]
    zc = z - z.mean()
    lag1 = np.sum(zc[1:] * zc[:-1]) / np.sum(zc * zc)
    assert lag1 == pytest.approx(params["phi_t"], abs=0.06)


def test_csv_round_trip_through_loader(params, tmp_path):
    sites = synth.uniform_sites(25, seed=9)
    z = synth.synthesize(sites, 4, params, seed=9)
    path = synth.write_xytz_csv(tmp_path / "f.csv", sites, z)
    z_l, coords, meta = load_kaust_csv_single(path, normalize=False,
                                              verbose=False)
    assert (meta["T"], meta["S"]) == (4, 25)
    np.testing.assert_allclose(coords, sites, atol=1e-6)
    np.testing.assert_allclose(z_l, z, atol=1e-6)


def test_ensure_field_generates_once(tmp_path):
    path = synth.ensure_field(tmp_path / "g.csv", S=12, T=3, seed=1)
    stamp = path.stat().st_mtime_ns
    assert synth.ensure_field(path, S=12, T=3, seed=1) == path
    assert path.stat().st_mtime_ns == stamp
    assert not list(tmp_path.glob(".*.tmp"))


def test_2a8_field_shape(tmp_path):
    path = synth.ensure_2a8_field(tmp_path)
    assert path == tmp_path / synth.FIELD_2A8
    z, coords, _ = load_kaust_csv_single(path, normalize=False,
                                         verbose=False)
    assert z.shape == synth.FIELD_2A8_SHAPE
    assert np.isfinite(z).all()
    assert coords.min() >= 0.0 and coords.max() <= 1.0
