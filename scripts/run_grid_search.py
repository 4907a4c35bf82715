#!/usr/bin/env python
"""Grid-search CLI (parity with the reference scripts/run_grid_search.py).

The in-file `PARAM_GRID` and `config_filter` mirror the reference's active
sweep (run_grid_search.py:257-285): 6 data files x wendland x
{uniform+fixed, kmeans_balanced+learnable} x random obs 10% corner. Edit in
place like the reference, or pass --param_grid JSON.

Execution: per config, the M experiment repeats run as ONE vmapped
program (engine=vmap) instead of a joblib process pool.
"""
import argparse
import json
import subprocess
import sys
from datetime import datetime
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.sweep.grid import run_grid_search

PARAM_GRID = {
    "data_file": ["data/2a/2a_7.csv", "data/2a/2a_8.csv", "data/2a/2a_9.csv",
                  "data/2b/2b_7.csv", "data/2b/2b_8.csv", "data/2b/2b_9.csv"],
    "spatial_basis_function": ["wendland"],
    "spatial_init_method": ["uniform", "kmeans_balanced"],
    "spatial_learnable": [True, False],
    "obs_method": ["random"],
    "obs_ratio": [0.10],
    "obs_spatial_pattern": ["corner"],
}


def config_filter(params):
    """uniform -> fixed only; data-adaptive inits -> learnable only
    (ref run_grid_search.py:278-285)."""
    if params["spatial_init_method"] == "uniform" and params["spatial_learnable"]:
        return False
    if params["spatial_init_method"] in ("gmm", "random_site",
                                         "kmeans_balanced") \
            and not params["spatial_learnable"]:
        return False
    return True


def main():
    parser = argparse.ArgumentParser(description="Grid Search Runner")
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--engine", type=str, default="vmap",
                        choices=["vmap", "sequential"])
    parser.add_argument("--parallel", action="store_true",
                        help="compat flag (vmap engine is the default)")
    parser.add_argument("--n_jobs", type=int, default=10,
                        help="compat flag (ignored)")
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--param_grid", type=str, default=None,
                        help="JSON dict overriding the in-file PARAM_GRID")
    parser.add_argument("--n_experiments", type=int, default=None)
    parser.add_argument("--dry-run", dest="dry_run", action="store_true",
                        help="list the generated configs and exit without "
                             "running any fit")
    args = parser.parse_args()

    base_config = ExperimentConfig.from_yaml(args.config).to_dict()
    if args.n_experiments is not None:
        base_config["n_experiments"] = args.n_experiments
    param_grid = json.loads(args.param_grid) if args.param_grid else PARAM_GRID

    if args.output_dir is None:
        from st_dadk_tpu.parallel.multihost import shared_timestamp
        args.output_dir = (f"results/"
                           f"{shared_timestamp().strftime('%Y%m%d_%H%M%S')}"
                           f"_grid_search")
    output_dir = Path(args.output_dir)

    print("=" * 80)
    print("GRID SEARCH RUNNER")
    for k, v in param_grid.items():
        print(f"  {k}: {v}")
    print(f"  output: {output_dir}  engine: {args.engine}")
    print("=" * 80)

    if args.dry_run:
        from st_dadk_tpu.sweep.grid import generate_config_combinations
        configs = generate_config_combinations(base_config, param_grid,
                                               config_filter)
        for i, c in enumerate(configs, 1):
            print(f"[{i:3d}] {c['tag']}")
        print(f"{len(configs)} configs (dry run; nothing executed)")
        return

    results = run_grid_search(base_config, param_grid, output_dir,
                              filter_fn=config_filter, engine=args.engine,
                              skip_existing=args.skip_existing)

    n_ok = sum(1 for r in results if r["status"] == "success")
    print(f"\nGRID SEARCH COMPLETE: {n_ok}/{len(results)} configs succeeded")
    print(f"Results: {output_dir}")

    if n_ok > 0:
        analysis = Path(__file__).parent / "analyze_grid_search.py"
        subprocess.run([sys.executable, str(analysis), str(output_dir)],
                       check=False)


if __name__ == "__main__":
    main()
