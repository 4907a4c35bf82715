"""Spatial-only dataset families (1a/3a: x,y,z with no time column) run
end-to-end as T=1 fields — a capability the reference's trainer lacks (its
loader requires a t column). Gated on the KAUST data mount."""
import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.train.experiment import run_single_experiment


def test_1a_end_to_end(ref_data_root, tmp_path):
    path = ref_data_root / "1a" / "1a_1_train.csv"
    if not path.exists():
        pytest.skip("1a data absent")
    cfg = ExperimentConfig.from_dict(dict(
        data_file=str(path), k_spatial_centers=[25, 81],
        k_temporal_centers=[4], hidden_dims=[64, 32], dropout=0.0,
        epochs=8, lr=1e-2, batch_size=4096, patience=50, warmup_epochs=1,
        scheduler="cosine", regression_type="mean", obs_method="site-wise",
        obs_ratio=0.5, split_method="random", base_seed=11,
        save_plots=False, save_artifacts=False))
    r = run_single_experiment(cfg, 1, tmp_path / "e", verbose=False)
    assert np.isfinite(r["test_rmse"])
    # interpolating a smooth spatial field: better than predicting the mean
    assert r["test_rmse"] < 1.1
