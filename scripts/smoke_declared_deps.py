#!/usr/bin/env python
"""Fresh-install smoke: prove the DECLARED dependency set is sufficient.

Past finding: scipy was imported by shipped features
(viz/plots.py griddata in every plots-on finalize, kmeans_exact's LP
fallback, Matern covariance fits) but not declared in
pyproject/requirements, so a fresh `pip install -r requirements.txt` user
crashed at first finalize. This script is the CI guard against that class
of drift: it runs in a venv holding ONLY requirements.txt (see
.github/workflows/test.yaml `declared-deps-smoke`), additionally BLOCKS
the known-optional modules in-process so a hard import of any of them
fails loudly even on a dev box that has them installed, then exercises:

  1. one real experiment end-to-end WITH plots (the scipy.griddata path),
  2. the GRID_SEARCH_GUIDE quick start: --dry-run, a micro grid, analyze.

Run locally:  python scripts/smoke_declared_deps.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# Env: virtual CPU mesh (CI has no GPU), set before any jax import anywhere.
# ---------------------------------------------------------------------------
ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "JAX_PLATFORM_NAME": "cpu",
    "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                  + " --xla_force_host_platform_device_count=8").strip(),
    # fail imports of optional/undeclared packages inside the children too
    "ST_DADK_SMOKE_BLOCK": "1",
}

# Modules that must NOT be required by the declared-deps path. sklearn /
# k_means_constrained / joblib / seaborn / tqdm are reference deps we never
# declared; orbax and torch are our own optional extras.
BLOCKED = ("orbax", "torch", "sklearn", "k_means_constrained", "joblib",
           "seaborn", "tqdm")

SITECUSTOMIZE = f"""
import sys

class _Blocker:
    BLOCKED = {BLOCKED!r}
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.BLOCKED:
            raise ImportError(
                f"[smoke_declared_deps] import of undeclared/optional "
                f"module {{name!r}} from the declared-deps path -- either "
                f"gate it or declare it in pyproject "
                f"[project.dependencies]")
        return None

import os
if os.environ.get("ST_DADK_SMOKE_BLOCK") == "1":
    sys.meta_path.insert(0, _Blocker())
"""


def run(cmd: list, cwd: Path, env: dict) -> None:
    print(f"[smoke] $ {' '.join(map(str, cmd))}", flush=True)
    subprocess.run([str(c) for c in cmd], cwd=str(cwd), env=env, check=True)


def main() -> int:
    tmp = Path(tempfile.mkdtemp(prefix="smoke_deps_"))

    # install the import blocker for every child python via sitecustomize
    site_dir = tmp / "site"
    site_dir.mkdir()
    (site_dir / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = {**ENV, "PYTHONPATH": f"{site_dir}:{ENV.get('PYTHONPATH', '')}"}

    # toy spatio-temporal CSV (same shape family as tests/test_batch_engine)
    import numpy as np
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = (np.sin(3 * coords[s, 0]) + 0.1 * t / 12
                 + rng.normal(0, 0.05))
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    csv = tmp / "toy.csv"
    csv.write_text("\n".join(lines))

    base_cfg = {
        "data_file": str(csv), "tag": "smoke",
        "k_spatial_centers": [9], "k_temporal_centers": [4],
        "hidden_dims": [16, 8], "dropout": 0.0, "epochs": 8, "lr": 5e-3,
        "batch_size": 64, "patience": 50, "warmup_epochs": 1,
        "scheduler": "cosine", "grad_clip": 10.0, "regression_type": "mean",
        "obs_method": "site-wise", "obs_ratio": 0.5,
        "obs_spatial_pattern": "uniform", "split_method": "random",
        "train_ratio": 0.8, "n_experiments": 2, "base_seed": 100,
        "save_plots": True, "save_artifacts": True,
    }
    cfg_path = tmp / "smoke.yaml"
    # plain YAML scalars/lists only; json is a valid YAML subset
    cfg_path.write_text(json.dumps(base_cfg))

    # 1. one experiment batch end-to-end WITH plots (exercises viz/plots.py
    #    -> scipy.interpolate.griddata in finalize)
    out1 = tmp / "exp"
    run([sys.executable, "scripts/train_st_interp.py", "--config", cfg_path,
         "--n_experiments", "2", "--engine", "vmap",
         "--output_dir", out1], REPO, env)
    res = out1 / "experiments" / "1" / "results.json"
    assert res.exists(), f"missing {res}"
    pngs = list((out1 / "experiments" / "1").glob("*.png"))
    assert pngs, "plots-on experiment produced no PNGs (griddata path)"
    print(f"[smoke] experiment OK: {len(pngs)} figures, results.json present")

    # 2. GRID_SEARCH_GUIDE quick start
    grid = json.dumps({"spatial_init_method": ["uniform", "random_site"],
                       "spatial_learnable": [True, False]})
    run([sys.executable, "scripts/run_grid_search.py", "--config", cfg_path,
         "--param_grid", grid, "--dry-run"], REPO, env)
    out2 = tmp / "grid_search"
    run([sys.executable, "scripts/run_grid_search.py", "--config", cfg_path,
         "--param_grid", grid, "--n_experiments", "1",
         "--output_dir", out2], REPO, env)
    assert (out2 / "grid_search_summary.csv").exists()
    run([sys.executable, "scripts/analyze_grid_search.py", out2], REPO, env)
    print("[smoke] grid quickstart OK")

    print("[OK] declared-deps smoke passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
