"""Sweep-layer tests: config generation/tagging/filtering, the grid CSV
contract, and the separate-models-per-tau quantile path."""
import json

import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.sweep.grid import (generate_config_combinations,
                                    run_grid_search, save_experiment_results)
from st_dadk_tpu.train.experiment import run_single_experiment


class TestConfigGeneration:
    def test_cartesian_and_tags(self):
        base = {"epochs": 5, "n_experiments": 2}
        grid = {"spatial_init_method": ["uniform", "gmm"],
                "obs_ratio": [0.1, 0.3]}
        configs = generate_config_combinations(base, grid)
        assert len(configs) == 4
        assert configs[0]["tag"] == "config001_uni_10"
        assert configs[-1]["tag"] == "config004_gmm_30"
        assert [c["config_id"] for c in configs] == [1, 2, 3, 4]
        assert all(c["epochs"] == 5 for c in configs)

    def test_filter_renumbers(self):
        base = {}
        grid = {"spatial_init_method": ["uniform", "gmm"],
                "spatial_learnable": [True, False]}

        def f(p):
            if p["spatial_init_method"] == "uniform" and p["spatial_learnable"]:
                return False
            if p["spatial_init_method"] == "gmm" and not p["spatial_learnable"]:
                return False
            return True

        configs = generate_config_combinations(base, grid, f)
        assert len(configs) == 2
        # numbering counts kept configs only (ref run_grid_search.py:48-65)
        assert configs[0]["tag"] == "config001_uni_fix"
        assert configs[1]["tag"] == "config002_gmm_lrn"

    def test_tag_abbreviations(self):
        base = {}
        grid = {"spatial_basis_function": ["triangular"],
                "obs_method": ["site-wise"],
                "obs_spatial_pattern": ["corner"]}
        c = generate_config_combinations(base, grid)[0]
        assert c["tag"] == "config001_tria_site_cor"


class TestCSVContract:
    def test_save_experiment_results(self, tmp_path):
        summary = {
            "n_experiments": 2,
            "statistics": {
                "test_rmse": {"mean": 1.0, "std": 0.1, "min": 0.9,
                              "max": 1.1, "median": 1.0,
                              "values": [0.9, 1.1]},
                "total_time_seconds": {"mean": 5.0, "std": 0.0, "min": 5.0,
                                       "max": 5.0, "median": 5.0,
                                       "values": [5.0, 5.0]},
            },
        }
        config = {"config_id": 1, "tag": "config001_x",
                  "spatial_init_method": "uniform", "spatial_learnable": False,
                  "obs_method": "random", "obs_ratio": 0.1,
                  "obs_spatial_pattern": "corner",
                  "spatial_basis_function": "wendland"}
        results = [{"config": config, "summary": summary, "status": "success"},
                   {"config": {**config, "config_id": 2, "tag": "config002_y"},
                    "summary": None, "status": "failed"}]
        df_s, df_d = save_experiment_results(results, tmp_path)
        assert (tmp_path / "grid_search_summary.csv").exists()
        assert (tmp_path / "grid_search_detail.csv").exists()
        assert (tmp_path / "grid_search_configs.json").exists()
        assert (tmp_path / "grid_search_configs.csv").exists()
        assert len(df_s) == 1                      # failed config excluded
        assert df_s.iloc[0]["test_rmse_mean"] == 1.0
        assert len(df_d) == 2                      # one row per experiment
        with open(tmp_path / "grid_search_configs.json") as f:
            assert set(json.load(f).keys()) == {"1", "2"}


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(30, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 11):
        for s in range(30):
            z = np.cos(4 * coords[s, 1]) + rng.normal(0, 0.05)
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},{z:.6f}")
    p = tmp_path / "toy.csv"
    p.write_text("\n".join(lines))
    return p


class TestQuantileSeparateModels:
    def test_per_tau_fits_and_crps_aggregation(self, toy_csv, tmp_path):
        """regression_type='quantile' with multiple levels trains one model
        per tau in quantile_<tau>/ subdirs and aggregates CRPS
        (ref run_single_experiment :1973-2151)."""
        cfg = ExperimentConfig.from_dict(dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=6, lr=5e-3, batch_size=64, patience=50, warmup_epochs=1,
            scheduler="cosine", regression_type="quantile",
            quantile_levels=[0.25, 0.5, 0.75], obs_method="site-wise",
            obs_ratio=0.5, split_method="random", base_seed=7,
            save_plots=False))
        out = tmp_path / "exp1"
        r = run_single_experiment(cfg, 1, out, verbose=False)
        assert r["regression_type"] == "quantile"
        for q in (0.25, 0.5, 0.75):
            qdir = out / f"quantile_{q}"
            assert (qdir / "results.json").exists()
            with open(qdir / "results.json") as f:
                qr = json.load(f)
            assert qr["quantile_level"] == q
            assert "test_check_loss" in qr
        assert np.isfinite(r["test_crps"])
        assert np.isfinite(r["train_crps"])
        # flat keys use check loss (ref :2079-2084)
        assert np.isclose(r["test_rmse"], np.sqrt(r["test_check_loss"]))
        assert (out / "results.json").exists()

    def test_per_tau_without_artifacts(self, toy_csv, tmp_path):
        """Regression: per-tau aggregation with
        save_artifacts=False crashed with KeyError('_split_predictions')
        after all fits completed; split predictions must be computed for
        quantile fits regardless of artifact persistence."""
        cfg = ExperimentConfig.from_dict(dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=4, lr=5e-3, batch_size=64, patience=50,
            regression_type="quantile", quantile_levels=[0.25, 0.75],
            obs_method="site-wise", obs_ratio=0.5, split_method="random",
            base_seed=7, save_plots=False,
            save_artifacts=False))
        out = tmp_path / "exp_noart"
        r = run_single_experiment(cfg, 1, out, verbose=False)
        assert np.isfinite(r["test_crps"])
        assert not (out / "quantile_0.25" / "predictions.npz").exists()

    def test_skip_existing_reuses_tau_fits(self, toy_csv, tmp_path):
        cfg = ExperimentConfig.from_dict(dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=4, lr=5e-3, batch_size=64, patience=50,
            regression_type="quantile", quantile_levels=[0.25, 0.75],
            obs_method="site-wise", obs_ratio=0.5, split_method="random",
            base_seed=7, save_plots=False))
        out = tmp_path / "exp1"
        r1 = run_single_experiment(cfg, 1, out, verbose=False)
        t0 = (out / "quantile_0.25" / "results.json").stat().st_mtime
        r2 = run_single_experiment(cfg, 1, out, verbose=False,
                                   skip_existing=True)
        assert (out / "quantile_0.25" / "results.json").stat().st_mtime == t0
        assert np.isclose(r1["test_crps"], r2["test_crps"], rtol=1e-6)


class TestGridSearchEndToEnd:
    def test_small_grid(self, toy_csv, tmp_path):
        base = dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=4, lr=5e-3, batch_size=64, patience=50,
            regression_type="mean", obs_method="site-wise", obs_ratio=0.5,
            split_method="random", n_experiments=2, base_seed=3,
            save_plots=False, save_artifacts=False)
        grid = {"obs_ratio": [0.4, 0.6]}
        out = tmp_path / "grid"
        results = run_grid_search(base, grid, out, engine="vmap")
        assert len(results) == 2
        assert all(r["status"] == "success" for r in results)
        assert (out / "grid_search_summary.csv").exists()
        import pandas as pd
        df = pd.read_csv(out / "grid_search_summary.csv")
        assert len(df) == 2
        assert df["n_experiments"].tolist() == [2, 2]


class TestConfigStacking:
    def test_stacked_grid_matches_per_config(self, toy_csv, tmp_path):
        """Config-level stacking must produce the same per-config results as
        running each config's batch separately (identical seeds/masks)."""
        base = dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=5, lr=5e-3, batch_size=64, patience=50,
            regression_type="mean", obs_method="site-wise",
            split_method="random", n_experiments=2, base_seed=3,
            save_plots=False, save_artifacts=False)
        grid = {"obs_ratio": [0.5, 0.6]}

        out_stacked = tmp_path / "stacked"
        rs = run_grid_search(base, grid, out_stacked, engine="vmap")
        assert all(r["status"] == "success" for r in rs)

        # reference: each config separately through the batch engine
        from st_dadk_tpu.train.batch_engine import run_experiment_batch
        from st_dadk_tpu.sweep.grid import generate_config_combinations
        configs = generate_config_combinations(base, grid)
        for c in configs:
            sep = run_experiment_batch(
                ExperimentConfig.from_dict(c), [1, 2],
                tmp_path / "sep" / c["tag"])
            for e, r_sep in zip((1, 2), sep):
                with open(out_stacked / c["tag"] / "experiments" / str(e)
                          / "results.json") as f:
                    r_st = json.load(f)
                # same masks/init; trained in a stacked batch whose shared
                # caps may differ slightly AND whose mixed lane sizes take
                # the partitioned 'perm' shuffle while the separate uniform
                # batch takes 'hash' — different but equally-distributed
                # batch orders -> close, not necessarily equal
                assert np.isclose(r_st["test_rmse"], r_sep["test_rmse"],
                                  rtol=0.12), (c["tag"], e)

    def test_unstackable_configs_split_buckets(self, toy_csv, tmp_path):
        base = dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=4, lr=5e-3, batch_size=64, patience=50,
            regression_type="mean", obs_method="site-wise", obs_ratio=0.5,
            split_method="random", n_experiments=1, base_seed=3,
            save_plots=False, save_artifacts=False)
        # spatial_learnable changes the compiled program -> separate buckets
        grid = {"spatial_learnable": [False, True]}
        rs = run_grid_search(base, grid, tmp_path / "g", engine="vmap")
        assert all(r["status"] == "success" for r in rs)
        assert rs[0]["summary"]["n_experiments"] == 1


class TestGridPerTauStacking:
    def test_grid_vmap_handles_per_tau_quantile(self, toy_csv, tmp_path):
        """A grid config in the separate-models-per-tau quantile mode runs
        on the stacked vmap engine: per-tau lanes + aggregated results."""
        import json

        from st_dadk_tpu.sweep.grid import run_grid_search

        base = dict(
            data_file=str(toy_csv), k_spatial_centers=[9],
            k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
            epochs=8, lr=5e-3, batch_size=64, patience=50, warmup_epochs=1,
            scheduler="cosine", regression_type="quantile",
            quantile_levels=[0.25, 0.75], obs_method="site-wise",
            split_method="random", base_seed=7, n_experiments=2,
            save_plots=False)
        out = tmp_path / "gq"
        res = run_grid_search(base, {"obs_ratio": [0.5]}, out,
                              engine="vmap")
        assert len(res) == 1 and res[0]["status"] == "success"
        cfg_dir = out / res[0]["config"]["tag"]
        for e in (1, 2):
            with open(cfg_dir / "experiments" / str(e) /
                      "results.json") as f:
                r = json.load(f)
            assert r["regression_type"] == "quantile"
            assert "test_crps" in r
            for q in (0.25, 0.75):
                assert (cfg_dir / "experiments" / str(e) /
                        f"quantile_{q}" / "results.json").exists()
        s = res[0]["summary"]
        assert s["n_experiments"] == 2
