#!/usr/bin/env python
"""Resume / repair a grid-search run (parity with the reference
scripts/resume_grid_search.py): discover config dirs by their config.yaml +
experiments/ tree, re-run an experiment-ID range per config (optionally
skipping ones with results.json), or just regenerate summaries and the
grid-level CSVs from whatever is on disk."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

import yaml

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.sweep.grid import save_experiment_results
from st_dadk_tpu.train.runner import (aggregate_results, load_all_results,
                                      run_multiple_experiments)


def discover_config_dirs(results_dir: Path):
    """Config dirs = those holding a config.yaml and an experiments/ tree
    (ref resume_grid_search.py:44-51)."""
    dirs = []
    for cfg_file in sorted(results_dir.glob("**/config.yaml")):
        cdir = cfg_file.parent
        if (cdir / "experiments").exists():
            dirs.append(cdir)
    return dirs


def regenerate(results_dir: Path):
    """Re-aggregate every config from its results.json files and rewrite the
    grid-level CSVs (ref :169-346)."""
    all_results = []
    loaded = []
    for cdir in discover_config_dirs(results_dir):
        with open(cdir / "config.yaml") as f:
            config = yaml.safe_load(f)
        n_exp = config.get("n_experiments", 10)
        results = load_all_results(cdir / "experiments", n_exp)
        summary = None
        if results:
            summary = aggregate_results(results, cdir / "summary")
        loaded.append((config, summary))
    # backfill ids for config dirs lacking one (e.g. a table-4.4 or hand-
    # added dir mixed into the tree) ABOVE the real ids: len+1 could collide
    # with an existing config_id, and save_experiment_results keys its
    # configs_dict/detail rows by id, so a collision silently overwrites
    # one config's rows with the other's
    next_id = max((c.get("config_id", 0) for c, _ in loaded), default=0) + 1
    for config, summary in loaded:
        if "config_id" not in config:
            config["config_id"] = next_id
            next_id += 1
        all_results.append({"config": config, "summary": summary,
                            "status": "success" if summary else "empty"})
    if all_results:
        save_experiment_results(all_results, results_dir)
        print(f"[OK] regenerated grid CSVs for {len(all_results)} configs")
    return all_results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("results_dir", type=str)
    parser.add_argument("--start_exp_id", type=int, default=None)
    parser.add_argument("--end_exp_id", type=int, default=None)
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--summarize-only", action="store_true")
    parser.add_argument("--engine", type=str, default="vmap",
                        choices=["vmap", "sequential"])
    args = parser.parse_args()

    results_dir = Path(args.results_dir)
    if not results_dir.exists():
        sys.exit(f"not found: {results_dir}")

    if not args.summarize_only:
        for cdir in discover_config_dirs(results_dir):
            with open(cdir / "config.yaml") as f:
                config = yaml.safe_load(f)
            print(f"\n=== resuming {cdir.name} ===")
            run_multiple_experiments(
                ExperimentConfig.from_dict(config), cdir,
                start_exp_id=args.start_exp_id, end_exp_id=args.end_exp_id,
                skip_existing=args.skip_existing, engine=args.engine)

    regenerate(results_dir)


if __name__ == "__main__":
    main()
