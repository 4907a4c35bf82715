"""Tests for the family scoring harness + the 1b/3b true-scale synthesis.

Covers job enumeration across the
snapshot's train / splitsol / synth modes (scripts/score_families.py) and
the RFF Matern sampler used to reconstruct the withheld 1b/3b train files
(scripts/synthesize_1b3b.py). Reference context: the competition layout the
loaders consume, /root/reference/stnf/data/kaust_loader.py:19-175.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parent.parent


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth():
    return _load("synthesize_1b3b", "scripts/synthesize_1b3b.py")


@pytest.fixture(scope="module")
def scorer():
    return _load("score_families", "scripts/score_families.py")


class TestRFFSampler:
    def test_latent_is_unit_variance(self, synth):
        rng = np.random.default_rng(0)
        coords = rng.uniform(size=(4000, 2))
        om, ph = synth.matern_rff(
            dict(nu=1.0, range_=0.1), m=2048, seed=1)
        lat = synth.eval_latent(coords, om, ph)
        assert abs(lat.mean()) < 0.1
        assert 0.85 < lat.std() < 1.15

    def test_field_matches_fitted_covariance(self, synth):
        """fit -> sample -> refit round trip: the refitted range/sill land
        near the generating values (the estimator consistency check that
        justifies using the reconstruction as a true-scale stand-in)."""
        rng = np.random.default_rng(2)
        coords = rng.uniform(size=(6000, 2))
        p_true = dict(mean=1.5, std=2.0, sigma2=0.9, range_=0.12, nu=1.0,
                      nugget=0.1)
        om, ph = synth.matern_rff(p_true, m=4096, seed=3)
        lat = synth.eval_latent(coords, om, ph)
        z = synth.sample_field(p_true, lat, seed=4)
        p_fit = synth.fit_field(coords, z, seed=5)
        # mean/std are the realization's own empirical moments (one GRF
        # draw with range 0.12 on [0,1]^2 has ~70 effective samples, so
        # they differ from the ensemble values — that's the field, not the
        # estimator)
        assert p_fit["mean"] == pytest.approx(float(z.mean()))
        assert p_fit["std"] == pytest.approx(float(z.std()))
        # the correlation-structure parameters must be recovered
        assert 0.5 * p_true["range_"] < p_fit["range_"] < 2.0 * p_true["range_"]
        assert abs(p_fit["sigma2"] - p_true["sigma2"]) < 0.3

    def test_correlated_pair_mixing(self, synth):
        """3b's one-factor coregionalization: rho*shared + sqrt(1-rho^2)*indep
        reproduces the requested cross-correlation."""
        rng = np.random.default_rng(6)
        coords = rng.uniform(size=(4000, 2))
        # short range -> many effective samples, so the empirical corr of
        # one realization concentrates near rho (range 0.08 left only ~150
        # effective DOF and a ~0.05 sampling std)
        p = dict(nu=1.0, range_=0.03)
        om, ph = synth.matern_rff(p, m=2048, seed=7)
        om2, ph2 = synth.matern_rff(p, m=2048, seed=8)
        lat_s = synth.eval_latent(coords, om, ph)
        lat_i = synth.eval_latent(coords, om2, ph2)
        rho = 0.6
        lat2 = rho * lat_s + np.sqrt(1 - rho * rho) * lat_i
        r = np.corrcoef(lat_s, lat2)[0, 1]
        assert abs(r - rho) < 0.1


class TestJobEnumeration:
    def _fake_tree(self, tmp_path: Path):
        """A reference-layout data dir: 1b ships test+solutions only."""
        d = tmp_path / "ref" / "1b"
        d.mkdir(parents=True)
        pd.DataFrame({"x": [0.1, 0.2], "y": [0.3, 0.4]}).to_csv(
            d / "1b_1_test.csv", index=False)
        pd.DataFrame({"id": [1, 2], "z1": [0.5, 0.6]}).to_csv(
            d / "1b-solutions.csv", index=False)
        s = tmp_path / "synth" / "1b"
        s.mkdir(parents=True)
        pd.DataFrame({"id_train": [1], "x": [0.1], "y": [0.2],
                      "z": [1.0]}).to_csv(s / "1b_1.csv", index=False)
        pd.DataFrame({"id": [1, 2], "z": [0.5, 0.6]}).to_csv(
            s / "1b_1_synthsol.csv", index=False)
        return tmp_path / "ref", tmp_path / "synth"

    def test_splitsol_and_synth_jobs(self, scorer, tmp_path):
        ref, syn = self._fake_tree(tmp_path)
        jobs = list(scorer.iter_jobs(["1b"], ref, syn))
        by_mode = {j["mode"]: j for j in jobs}
        assert set(by_mode) == {"splitsol", "synth"}
        assert by_mode["synth"]["sol_col"] == "z"
        assert by_mode["synth"]["sol_path"].name == "1b_1_synthsol.csv"
        assert by_mode["splitsol"]["sol_col"] == "z1"

    def test_no_synth_dir_means_no_synth_jobs(self, scorer, tmp_path):
        ref, _ = self._fake_tree(tmp_path)
        jobs = list(scorer.iter_jobs(["1b"], ref, None))
        assert {j["mode"] for j in jobs} == {"splitsol"}

    def test_real_snapshot_enumeration(self, scorer):
        """Against the actual reference mount: every family yields jobs in
        the documented mode (train for 1a/2a/3a, splitsol for 1b/3b)."""
        ref = Path("/root/reference/data")
        if not ref.exists():
            pytest.skip("reference mount absent")
        modes = {}
        for j in scorer.iter_jobs(["1a", "1b", "2a", "3a", "3b"], ref):
            modes.setdefault(j["fam"], set()).add(j["mode"])
        assert modes["1a"] == {"train"}
        assert modes["2a"] == {"train"}
        assert modes["3a"] == {"train"}
        assert modes["1b"] == {"splitsol"}
        assert modes["3b"] == {"splitsol"}
