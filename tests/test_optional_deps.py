"""The main path needs none of pandas, yaml and matplotlib: a child process
with all three blocked generates a field, runs the lane-batched engine with
artifacts on (plots off) and aggregates the results."""
import csv
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

CHILD = textwrap.dedent("""
    import json, sys
    for name in ("pandas", "yaml", "matplotlib"):
        sys.modules[name] = None          # any import of them now fails
    sys.path.insert(0, sys.argv[1])
    from pathlib import Path
    out = Path(sys.argv[2])
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.dataio.synth import ensure_field
    from st_dadk_tpu.train.runner import run_multiple_experiments
    field = ensure_field(out / "field.csv", S=30, T=5, seed=2)
    cfg = ExperimentConfig.from_dict(dict(
        data_file=str(field), n_experiments=3, base_seed=5, epochs=3,
        k_spatial_centers=[4], k_temporal_centers=[3], hidden_dims=[8],
        spatial_init_method="gmm", spatial_learnable=True,
        regression_type="multi-quantile", quantile_levels=[0.1, 0.5, 0.9],
        obs_ratio=0.5, batch_size=32, save_plots=False,
        save_artifacts=True))
    summary = run_multiple_experiments(cfg, out / "run", engine="vmap")
    blocked = [m for m in ("pandas", "yaml", "matplotlib")
               if sys.modules.get(m) is not None]
    print(json.dumps({"n": summary["n_experiments"], "loaded": blocked}))
""")


@pytest.fixture(scope="module")
def child_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("no_optional_deps")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", CHILD, str(REPO), str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), out / "run"


def test_engine_runs_without_optional_deps(child_run):
    report, _ = child_run
    assert report == {"n": 3, "loaded": []}


@pytest.mark.parametrize("exp_id", [1, 2, 3])
def test_lane_artifacts_written(child_run, exp_id):
    _, run = child_run
    lane = run / "experiments" / str(exp_id)
    res = json.loads((lane / "results.json").read_text())
    assert res["n_epochs_run"] >= 1
    for name in ("model_final.npz", "predictions.npz", "basis_info.npz"):
        assert (lane / name).exists()
    with open(lane / "training_history.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["epoch", "train_loss", "val_loss", "val_rmse",
                             "lr"]
    assert len(rows) == res["n_epochs_run"]
    assert float(rows[0]["train_loss"]) == pytest.approx(
        res["training_history"]["train_loss"][0])


def test_summary_csv_written(child_run):
    _, run = child_run
    with open(run / "summary" / "all_experiments.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["experiment_id"]) for r in rows] == [1, 2, 3]
    assert {"experiment_seed", "test_rmse", "test_crps"} <= set(rows[0])
    assert not list((run / "summary").glob("*.png"))
