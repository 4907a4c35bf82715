#!/usr/bin/env python
"""A/B: Sinkhorn-balanced k-means vs exact balanced k-means, end metric.

The reference's DA-STDK initializer is KMeansConstrained — an EXACT
size-constrained assignment (stnf/models/st_interp.py:340-431). This
framework's default `kmeans_balanced` uses a Sinkhorn-OT balanced
assignment (vmappable, runs on device inside the batch engine), with
`kmeans_exact` (auction-solver, host-side) available for strict fidelity.
docs/PARITY.md asserts the divergence is metric-neutral; this script
MEASURES it: 10 seeds of the Table-4.4 clustered
scenarios (where the data-adaptive init is the differentiator), same
protocol, both inits, test CRPS mean ± std side by side.

Usage:
    python scripts/ab_kmeans_divergence.py --n_experiments 10 \
        --out results/ab_kmeans_r3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

import numpy as np  # noqa: E402

sys.path.insert(0, str(REPO / "scripts"))
from run_table_4_4 import create_table_4_4_configs  # noqa: E402
from st_dadk_tpu.config import ExperimentConfig  # noqa: E402
from st_dadk_tpu.train.runner import (load_all_results,  # noqa: E402
                                      run_multiple_experiments)
from st_dadk_tpu.utils.io import save_json  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(REPO / "configs" /
                                            "config_st_interp.yaml"))
    ap.add_argument("--n_experiments", type=int, default=10)
    ap.add_argument("--data_file", default=None)
    ap.add_argument("--scenarios", nargs="+",
                    default=["Fixed_Clustered", "Random_Clustered"])
    ap.add_argument("--out", default=str(REPO / "results" / "ab_kmeans_r3"))
    ap.add_argument("--inits", nargs="+",
                    default=["kmeans_balanced", "kmeans_exact"],
                    help="subset of arms to (re)fit; the summary still "
                         "aggregates every completed arm found under --out")
    args = ap.parse_args()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    table = {}
    for init in ("kmeans_balanced", "kmeans_exact"):
        configs = create_table_4_4_configs(
            args.config, da_stdk_init_method=init, data_file=args.data_file,
            delta_penalty_mode="abs")
        for scenario, model, cfg in configs:
            if model != "DA-STDK" or scenario not in args.scenarios:
                continue
            cfg["n_experiments"] = args.n_experiments
            cdir = out / f"{init}_{scenario}"
            cdir.mkdir(parents=True, exist_ok=True)
            t0 = time.time()
            refit = init in args.inits
            if refit:
                print(f"\n=== {init} / {scenario} "
                      f"({args.n_experiments} seeds) ===", flush=True)
                run_multiple_experiments(ExperimentConfig.from_dict(cfg),
                                         cdir, engine="vmap")
            results = load_all_results(cdir / "experiments",
                                       args.n_experiments)
            crps = [r["test_crps"] for r in results if "test_crps" in r]
            rmse = [r["test_rmse"] for r in results if "test_rmse" in r]
            if not crps:
                continue
            table[f"{init}/{scenario}"] = {
                "n": len(crps),
                "test_crps_mean": float(np.mean(crps)),
                "test_crps_std": float(np.std(crps)),
                "test_rmse_mean": float(np.mean(rmse)),
                "wall_seconds": (round(time.time() - t0, 1) if refit
                                 else None),
            }
            e = table[f"{init}/{scenario}"]
            print(f"  {init}/{scenario}: CRPS {e['test_crps_mean']:.4f} ± "
                  f"{e['test_crps_std']:.4f}  RMSE {e['test_rmse_mean']:.4f}",
                  flush=True)

    save_json(table, out / "ab_summary.json")
    print(f"\n[OK] wrote {out / 'ab_summary.json'}")
    for sc in args.scenarios:
        a = table.get(f"kmeans_balanced/{sc}")
        b = table.get(f"kmeans_exact/{sc}")
        if a and b:
            d = a["test_crps_mean"] - b["test_crps_mean"]
            pooled = max(a["test_crps_std"], b["test_crps_std"], 1e-12)
            print(f"{sc}: sinkhorn-exact CRPS delta = {d:+.4f} "
                  f"({abs(d)/pooled:.2f} sigma)")


if __name__ == "__main__":
    main()
