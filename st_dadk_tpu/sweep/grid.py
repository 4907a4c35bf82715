"""Grid-search engine: config generation, execution, CSV contract.

Mirrors the reference's sweep harness (scripts/run_grid_search.py):
  - cartesian-product config generation with an optional filter and the same
    abbreviated tag synthesis (:22-99)
  - per-config output dirs with config.yaml snapshots (:341-346)
  - grid_search_summary.csv / grid_search_detail.csv /
    grid_search_configs.{json,csv} schemas (:102-237)

Execution replaces the reference's outer joblib pool over configs
(:331-387) with, per config, a vmapped batch of experiment repeats on the
device mesh (configs stream sequentially; each batch is one XLA program, so
config k+1 reuses config k's compilation whenever shapes match).
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.train.runner import run_multiple_experiments

_TAG_ABBREV = {
    "spatial_basis_function": {"wendland": "wend", "gaussian": "gaus",
                               "triangular": "tria"},
    "spatial_init_method": {"uniform": "uni", "gmm": "gmm",
                            "random_site": "rnd", "kmeans_balanced": "kmb",
                            "kmeans_exact": "kme"},
}


def _tag_part(param_name: str, param_value: Any) -> str:
    if param_name == "data_file":
        # the tag becomes a directory name — use the file stem, never a path
        from pathlib import Path as _P
        return _P(str(param_value)).stem
    if param_name in _TAG_ABBREV:
        return _TAG_ABBREV[param_name].get(param_value, str(param_value))
    if param_name == "spatial_learnable":
        return "lrn" if param_value else "fix"
    if param_name == "obs_method":
        return "site" if param_value == "site-wise" else "rand"
    if param_name == "obs_ratio":
        # int() truncation is deliberate reference parity (ref
        # run_grid_search.py:88: f'{int(param_value*100)}'), including its
        # binary-float off-by-one (0.29*100 -> '28') so tags/directories
        # match the reference's for identical grids
        return f"{int(param_value * 100)}"
    if param_name == "obs_spatial_pattern":
        return "cor" if param_value == "corner" else "unf"
    return str(param_value)


def generate_config_combinations(
    base_config: Dict[str, Any],
    param_grid: Dict[str, List[Any]],
    filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
) -> List[Dict[str, Any]]:
    """Cartesian product of param_grid over base_config, filtered, with
    abbreviated tags `configNNN_<parts>` numbered over kept configs only."""
    param_names = list(param_grid.keys())
    combinations = list(itertools.product(*param_grid.values()))

    configs = []
    counter = 0
    for combo in combinations:
        param_dict = dict(zip(param_names, combo))
        if filter_fn is not None and not filter_fn(param_dict):
            continue
        counter += 1
        config = dict(base_config)
        config.update(param_dict)
        tag_parts = [f"config{counter:03d}"]
        tag_parts += [_tag_part(n, v) for n, v in zip(param_names, combo)]
        config["tag"] = "_".join(tag_parts)
        config["config_id"] = counter
        configs.append(config)
    return configs


_SUMMARY_METRICS = ["test_rmse", "test_mae", "test_mse",
                    "valid_rmse", "valid_mae", "valid_mse",
                    "train_rmse", "train_mae", "train_mse",
                    "test_crps", "valid_crps", "train_crps",
                    "test_check_loss", "valid_check_loss", "train_check_loss",
                    "total_time_seconds"]
_CONFIG_COLS = ["spatial_basis_function", "spatial_init_method",
                "spatial_learnable", "obs_method", "obs_ratio",
                "obs_spatial_pattern"]


def save_experiment_results(all_results: List[Optional[Dict[str, Any]]],
                            output_dir: Path):
    """Write the three grid-level CSV/JSON artifacts (ref :102-237)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    summary_records = []
    detail_records: Dict[tuple, Dict[str, Any]] = {}
    config_records, configs_dict = [], {}

    for result in all_results:
        if result is None:
            continue
        config = result["config"]
        config_records.append({"config_id": config["config_id"],
                               "tag": config["tag"]})
        configs_dict[str(config["config_id"])] = config
        summary = result.get("summary")
        if summary is None:
            continue

        record = {"config_id": config["config_id"], "tag": config["tag"]}
        for c in _CONFIG_COLS:
            record[c] = config.get(c)
        record["n_experiments"] = summary["n_experiments"]
        for metric in _SUMMARY_METRICS:
            if metric in summary["statistics"]:
                stats = summary["statistics"][metric]
                for s in ("mean", "std", "min", "max", "median"):
                    record[f"{metric}_{s}"] = stats[s]
        summary_records.append(record)

        for metric in _SUMMARY_METRICS:
            if metric not in summary["statistics"]:
                continue
            # enumerate(values, 1) relabels rows when a repeat is missing
            # (gap shifts later ids) — deliberate reference parity with
            # run_grid_search.py:182; the CSV schema feeds the same analyzers
            for exp_id, value in enumerate(
                    summary["statistics"][metric]["values"], 1):
                key = (config["config_id"], exp_id)
                if key not in detail_records:
                    rec = {"config_id": config["config_id"],
                           "tag": config["tag"], "experiment_id": exp_id}
                    for c in _CONFIG_COLS:
                        rec[c] = config.get(c)
                    detail_records[key] = rec
                detail_records[key][metric] = value

    import pandas as pd
    df_summary = pd.DataFrame(summary_records)
    df_summary.to_csv(output_dir / "grid_search_summary.csv", index=False)
    df_detail = pd.DataFrame(list(detail_records.values()))
    df_detail.to_csv(output_dir / "grid_search_detail.csv", index=False)
    with open(output_dir / "grid_search_configs.json", "w",
              encoding="utf-8") as f:
        json.dump(configs_dict, f, indent=2, ensure_ascii=False, default=str)
    pd.DataFrame(config_records).to_csv(
        output_dir / "grid_search_configs.csv", index=False)
    return df_summary, df_detail


def run_grid_search(
    base_config: Dict[str, Any],
    param_grid: Dict[str, List[Any]],
    output_dir: Path,
    filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
    engine: str = "vmap",
    skip_existing: bool = False,
    verbose: bool = False,
) -> List[Dict[str, Any]]:
    """Run the full grid.

    engine='vmap': configs are bucketed by stacking key (identical model/loop
    hyperparameters) and dataset shape, and every bucket's configs x repeats
    run as ONE vmapped device program (config-level stacking on top of
    experiment-level stacking). 'sequential' falls back to per-config,
    per-experiment execution.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    configs = generate_config_combinations(base_config, param_grid, filter_fn)
    n_configs = len(configs)

    import yaml
    for config in configs:
        config_dir = output_dir / config["tag"]
        config_dir.mkdir(parents=True, exist_ok=True)
        with open(config_dir / "config.yaml", "w") as f:
            yaml.dump(config, f, default_flow_style=False)

    all_results = []
    if engine == "vmap":
        all_results = _run_grid_stacked(configs, output_dir,
                                        skip_existing=skip_existing,
                                        verbose=verbose)
    else:
        for i, config in enumerate(configs, 1):
            print(f"[{i}/{n_configs}] {config['tag']}")
            config_dir = output_dir / config["tag"]
            try:
                summary = run_multiple_experiments(
                    ExperimentConfig.from_dict(config), config_dir,
                    skip_existing=skip_existing, verbose=verbose,
                    engine=engine)
                all_results.append({"config": config, "summary": summary,
                                    "status": "success"})
            except Exception as e:
                import traceback
                traceback.print_exc()
                all_results.append({"config": config, "summary": None,
                                    "status": "failed", "error": str(e)})

    from st_dadk_tpu.parallel.multihost import is_primary
    if is_primary():
        save_experiment_results(all_results, output_dir)
    return all_results


def _run_grid_stacked(configs: List[Dict[str, Any]], output_dir: Path,
                      skip_existing: bool, verbose: bool
                      ) -> List[Dict[str, Any]]:
    """Bucket configs by stacking key + dataset shape; one vmapped job batch
    per bucket; then per-config aggregation preserving the filesystem
    contract."""
    from st_dadk_tpu.train.batch_engine import run_lane_jobs, stacking_key
    from st_dadk_tpu.train.experiment import _load_cached
    from st_dadk_tpu.train.runner import aggregate_results, load_all_results

    cfg_objs = [ExperimentConfig.from_dict(c) for c in configs]

    # ragged-k stacking (SURVEY §7.1 step 6): configs whose stacking key
    # differs ONLY in k_spatial_centers share one padded program — set
    # k_spatial_pad = the group's max total k on every member, after which
    # stacking_key treats the real k layout as a lane property.
    ragged_groups: Dict[Any, List[int]] = {}
    for i, c in enumerate(cfg_objs):
        key_wo_k = stacking_key(c.replace(k_spatial_pad=-1))
        ragged_groups.setdefault(key_wo_k, []).append(i)
    for members in ragged_groups.values():
        klists = {tuple(cfg_objs[i].k_spatial_centers) for i in members}
        if len(klists) > 1 and all(cfg_objs[i].k_spatial_pad is None
                                   for i in members):
            k_pad = max(sum(k) for k in klists)
            for i in members:
                cfg_objs[i] = cfg_objs[i].replace(k_spatial_pad=k_pad)

    buckets: Dict[Any, List[int]] = {}
    for i, c in enumerate(cfg_objs):
        try:
            z, _, _ = _load_cached(c.resolve_data_file(), c.normalize_target,
                                   False)
            shape = z.shape
        except Exception:
            shape = ("unknown", configs[i]["tag"])
        buckets.setdefault((stacking_key(c), shape), []).append(i)

    from st_dadk_tpu.train.batch_engine import (aggregate_per_tau,
                                                expand_per_tau_jobs,
                                                is_per_tau)

    failed: Dict[int, str] = {}
    per_tau: List[int] = []              # config idxs to aggregate after
    for b_idx, (key, members) in enumerate(buckets.items(), 1):
        jobs = []
        for i in members:
            exp_dir = output_dir / configs[i]["tag"] / "experiments"
            c = cfg_objs[i]
            ids = list(range(1, c.n_experiments + 1))
            if is_per_tau(c):
                # separate-models-per-tau: one lane per (experiment, tau)
                jobs.extend(expand_per_tau_jobs(c, ids, exp_dir))
                per_tau.append(i)
            else:
                jobs.extend((c, e, exp_dir / str(e)) for e in ids)
        print(f"[bucket {b_idx}/{len(buckets)}] {len(members)} configs x "
              f"{cfg_objs[members[0]].n_experiments} repeats = "
              f"{len(jobs)} lanes")
        try:
            # width-split stream: buckets wider than the measured sweet spot
            # (LANES_PER_DEVICE x mesh devices) pipeline as several batches
            run_lane_jobs(jobs, cfg_objs[members[0]],
                          skip_existing=skip_existing, verbose=verbose)
        except Exception as e:
            import traceback
            traceback.print_exc()
            for i in members:
                failed[i] = str(e)

    # multi-process: every host wrote its own lanes' results.json; aggregate
    # once, on the primary, after all writes are visible
    from st_dadk_tpu.parallel.multihost import is_primary, sync_processes
    sync_processes("st_dadk_grid_aggregate")
    if not is_primary():
        return []

    for i in per_tau:
        if i in failed:
            continue
        exp_dir = output_dir / configs[i]["tag"] / "experiments"
        try:
            aggregate_per_tau(cfg_objs[i],
                              list(range(1, cfg_objs[i].n_experiments + 1)),
                              exp_dir, skip_existing=skip_existing, sync=False)
        except Exception as err:
            failed[i] = str(err)

    all_results = []
    for i, config in enumerate(configs):
        config_dir = output_dir / config["tag"]
        if i in failed:
            all_results.append({"config": config, "summary": None,
                                "status": "failed", "error": failed[i]})
            continue
        results = load_all_results(config_dir / "experiments",
                                   cfg_objs[i].n_experiments)
        summary = (aggregate_results(results, config_dir / "summary")
                   if results else None)
        all_results.append({"config": config, "summary": summary,
                            "status": "success" if summary else "failed"})
    return all_results
