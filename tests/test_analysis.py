"""Analysis-layer smoke tests: analyze_grid_search and resume_grid_search
work against a real (tiny) grid-search results tree."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def grid_results(tmp_path_factory):
    from st_dadk_tpu.sweep.grid import run_grid_search
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(25, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 9):
        for s in range(25):
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},"
                         f"{np.sin(coords[s,0]*5)+rng.normal(0,0.05):.6f}")
    csv = tmp / "toy.csv"
    csv.write_text("\n".join(lines))

    base = dict(data_file=str(csv), k_spatial_centers=[9],
                k_temporal_centers=[4], hidden_dims=[12, 8], dropout=0.0,
                epochs=3, lr=5e-3, batch_size=64, patience=50,
                regression_type="mean", obs_method="site-wise", obs_ratio=0.6,
                split_method="random", n_experiments=2, base_seed=5,
                save_plots=False, save_artifacts=False)
    out = tmp / "results"
    run_grid_search(base, {"obs_ratio": [0.4, 0.6]}, out, engine="vmap")
    return out


def _run(script, *args):
    env = {"JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu",
           "PATH": "/usr/bin:/bin:/usr/local/bin"}
    import os
    env.update({k: v for k, v in os.environ.items()
                if k not in env})
    return subprocess.run([sys.executable, str(REPO / "scripts" / script),
                           *args], capture_output=True, text=True,
                          cwd=str(REPO), env=env)


def test_analyze_grid_search(grid_results):
    r = _run("analyze_grid_search.py", str(grid_results))
    assert r.returncode == 0, r.stderr[-2000:]
    assert (grid_results / "detailed_summary.csv").exists()
    assert (grid_results / "boxplot_test_rmse.png").exists()
    assert "best test_rmse" in r.stdout


def test_resume_summarize_only(grid_results):
    r = _run("resume_grid_search.py", str(grid_results), "--summarize-only")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (grid_results / "grid_search_summary.csv").exists()
    import pandas as pd
    df = pd.read_csv(grid_results / "grid_search_summary.csv")
    assert len(df) == 2
