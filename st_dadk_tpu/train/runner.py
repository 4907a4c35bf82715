"""Multi-experiment orchestration + aggregation.

Replaces the reference's joblib process fan-out (train_st_interp.py:2914-3026)
with sequential dispatch of jitted fits (XLA programs are cached across
repeats since shapes/specs match) — and, when
requested, the vmapped batch engine (st_dadk_tpu.train.batch_engine) that runs
all repeats as one device program.

The filesystem contract is preserved:
    <output_dir>/experiments/<i>/results.json
    <output_dir>/summary/summary_statistics.json
    <output_dir>/summary/all_experiments.csv
Aggregation always re-scans ALL existing results.json (ref :3009-3026).
"""
from __future__ import annotations

import json
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.train.experiment import run_single_experiment
from st_dadk_tpu.utils.io import save_json, write_csv

AGG_METRICS = ["train_mse", "train_mae", "train_rmse",
               "valid_mse", "valid_mae", "valid_rmse",
               "test_mse", "test_mae", "test_rmse",
               "total_time_seconds"]
QUANTILE_METRICS = ["train_crps", "valid_crps", "test_crps",
                    "train_check_loss", "valid_check_loss", "test_check_loss"]


def aggregate_results(all_results: List[Dict[str, Any]], summary_dir: Path
                      ) -> Dict[str, Any]:
    """mean/std/min/max/median per metric (ref :2790-2911)."""
    summary_dir = Path(summary_dir)
    summary_dir.mkdir(parents=True, exist_ok=True)
    n = len(all_results)

    metrics_data: Dict[str, List[float]] = {m: [] for m in AGG_METRICS}
    for result in all_results:
        if "metrics" in result:
            for split in ("train", "valid", "test"):
                for m in ("mse", "mae", "rmse"):
                    metrics_data[f"{split}_{m}"].append(
                        result["metrics"][split][m])
        else:
            # .get(key, 0) zero-fill on missing metrics is deliberate
            # reference parity (train_st_interp.py:2833-2841) — a mixed-
            # schema experiments dir deflates the aggregate there too
            for key in AGG_METRICS:
                if key != "total_time_seconds":
                    metrics_data[key].append(result.get(key, 0))
        metrics_data["total_time_seconds"].append(
            result.get("total_time_seconds", 0.0))

    # quantile/multi-quantile extras when present
    extra = {}
    for m in QUANTILE_METRICS:
        vals = [r[m] for r in all_results if m in r]
        if len(vals) == n and n > 0:
            extra[m] = vals
    metrics_data.update(extra)

    summary: Dict[str, Any] = {"n_experiments": n, "statistics": {}}
    for name, values in metrics_data.items():
        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            continue
        summary["statistics"][name] = {
            "mean": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max()),
            "median": float(np.median(arr)),
            "values": [float(v) for v in arr],
        }

    save_json(summary, summary_dir / "summary_statistics.json")

    # cross-experiment maps (ref :2869-2873); best-effort, figures only,
    # and only when the experiments ran with plots on
    exp_dirs = [Path(r["config"]["output_dir"]) for r in all_results
                if isinstance(r.get("config"), dict)
                and r["config"].get("output_dir")
                and r["config"].get("save_plots", True)]
    if exp_dirs:
        try:
            from st_dadk_tpu.viz.plots import (create_averaged_spatial_mse,
                                               create_observation_density_map)
            create_averaged_spatial_mse(exp_dirs, summary_dir)
            create_observation_density_map(exp_dirs, summary_dir)
        except Exception as e:
            print(f"[WARNING] summary figures failed: {e}")

    df_data: Dict[str, Any] = {
        "experiment_id": [r.get("experiment_id", i + 1)
                          for i, r in enumerate(all_results)]}
    if all_results and "experiment_seed" in all_results[0]:
        df_data["experiment_seed"] = [r["experiment_seed"] for r in all_results]
    for name, values in metrics_data.items():
        if len(values) == n:
            df_data[name] = values
    write_csv(summary_dir / "all_experiments.csv", df_data)
    return summary


def load_all_results(experiments_dir: Path, n_experiments: int
                     ) -> List[Dict[str, Any]]:
    out = []
    for i in range(1, n_experiments + 1):
        f = Path(experiments_dir) / str(i) / "results.json"
        if f.exists():
            with open(f) as fh:
                out.append(json.load(fh))
    return out


def run_multiple_experiments(
    config: ExperimentConfig | Dict[str, Any],
    output_dir: Path,
    start_exp_id: Optional[int] = None,
    end_exp_id: Optional[int] = None,
    skip_existing: bool = False,
    verbose: bool = False,
    engine: str = "sequential",
) -> Optional[Dict[str, Any]]:
    """Run repeats [start, end] and aggregate everything on disk.

    engine='sequential' dispatches jitted fits one by one (compilation is
    shared); engine='vmap' uses the batch engine to run all repeats as a
    single vmapped device program (st_dadk_tpu.train.batch_engine);
    engine='dp' runs fits sequentially but each fit data-parallel over ALL
    devices (minibatch sharding + gradient all-reduce; right for large
    single fits, SURVEY.md section 2.4 row 3).
    """
    if engine not in ("sequential", "vmap", "dp"):
        raise ValueError(f"Unknown engine {engine!r}: expected "
                         "'sequential', 'vmap' or 'dp'")
    cfg = (config if isinstance(config, ExperimentConfig)
           else ExperimentConfig.from_dict(config))
    n_experiments = cfg.n_experiments
    start_id = start_exp_id or 1
    end_id = end_exp_id or n_experiments

    output_dir = Path(output_dir)
    experiments_dir = output_dir / "experiments"
    experiments_dir.mkdir(parents=True, exist_ok=True)

    from st_dadk_tpu.parallel.multihost import process_info
    pc, pid = process_info()

    if engine == "vmap":
        from st_dadk_tpu.train.batch_engine import run_experiment_batch
        run_experiment_batch(cfg, list(range(start_id, end_id + 1)),
                             experiments_dir, skip_existing=skip_existing,
                             verbose=verbose)
    else:
        mesh = None
        write = True
        if engine == "dp":
            import jax
            from jax.sharding import Mesh
            # global mesh: on a pod EVERY process drives each fit in
            # lockstep (the per-step all-reduce spans hosts) and computes
            # identical replicated results; only the primary writes
            mesh = Mesh(np.array(jax.devices()), ("data",))
            if pc > 1:
                from st_dadk_tpu.parallel.multihost import is_primary
                write = is_primary()
        for i in range(start_id, end_id + 1):
            if engine != "dp" and pc > 1 and (i - start_id) % pc != pid:
                continue   # sequential fits stripe across pod processes
            exp_dir = experiments_dir / str(i)
            exp_dir.mkdir(parents=True, exist_ok=True)
            try:
                run_single_experiment(cfg, i, exp_dir, verbose=verbose,
                                      skip_existing=skip_existing, mesh=mesh,
                                      write_artifacts=write)
            except Exception as e:
                print(f"[FAILED] Experiment {i}: {e}")
                if write:
                    with open(exp_dir / "error.txt", "w") as f:
                        f.write(f"Experiment {i} FAILED\nError: {e}\n\n")
                        f.write(traceback.format_exc())
                continue

    # On a multi-process mesh each process wrote only ITS lanes' artifacts
    # (batch_engine._owned_lane_slice); wait for every host's writes to land
    # on the shared filesystem, then aggregate once on the primary process.
    from st_dadk_tpu.parallel.multihost import is_primary, sync_processes
    sync_processes("st_dadk_aggregate")
    if not is_primary():
        return None
    all_results = load_all_results(experiments_dir, n_experiments)
    if all_results:
        return aggregate_results(all_results, output_dir / "summary")
    return None
