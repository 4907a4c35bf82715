#!/usr/bin/env python
"""Attribute the mixed-grid heterogeneity cost (scripts/bench_mixed_grid.py).

Two probes, both drift-controlled by interleaving arms in one process:

  grid-tail: time `run_lane_jobs` inside a full `run_grid_search` call to
      split the lane stream from the grid machinery around it (bucketing,
      per-config aggregation, CSV contract). Measured: the machinery is
      0.07-0.08 s per 48-fit grid.

  stage-split: run the mixed 48-fit stream and a homogeneous 48-fit
      stream of the same lane count through `run_job_batches`, harvesting
      each batch's setup/train walls from the engine's stage timers.
      Measured: setup walls are identical across arms; the mixed excess is
      entirely train time, i.e. critical-path epochs of the harder swept
      configs (2a_9 trains to the 500-epoch cap, mean 484 epochs, vs ~112
      for 2a_8), not stacking overhead.

Usage:
    python scripts/profile_mixed_grid.py [--reps 3]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)

apply_platform_env()
enable_compile_cache()

DATA = ["data/2a/2a_7.csv", "data/2a/2a_8.csv", "data/2a/2a_9.csv"]
PATTERNS = ["corner", "uniform"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import json

    import numpy as np

    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.sweep.grid import run_grid_search
    from st_dadk_tpu.train import batch_engine
    from st_dadk_tpu.train.batch_engine import run_job_batches

    tmp = Path(tempfile.mkdtemp(prefix="prof_mixed_grid_"))
    base = bench_workload(n_experiments=8)

    # -- probe 1: grid machinery vs lane stream -----------------------------
    orig_rlj = batch_engine.run_lane_jobs
    lane_wall = []

    def timed_rlj(*a, **kw):
        t0 = time.time()
        out = orig_rlj(*a, **kw)
        lane_wall.append(time.time() - t0)
        return out

    batch_engine.run_lane_jobs = timed_rlj
    param_grid = {"data_file": DATA, "obs_spatial_pattern": PATTERNS}
    for rep in range(args.reps):
        lane_wall.clear()
        t0 = time.time()
        run_grid_search({**base, "base_seed": 2025 + rep * 1000}, param_grid,
                        tmp / f"g{rep}", engine="vmap")
        total = time.time() - t0
        print(f"[grid-tail] rep{rep}: total={total:.2f}s "
              f"lane_jobs={sum(lane_wall):.2f}s "
              f"machinery={total - sum(lane_wall):.2f}s", flush=True)
    batch_engine.run_lane_jobs = orig_rlj

    # -- probe 2: per-batch stage split, mixed vs homogeneous ---------------
    def mixed_batches(rep):
        jobs = []
        for i, (df, p) in enumerate((d, p) for d in DATA for p in PATTERNS):
            cfg = ExperimentConfig.from_dict(bench_workload(
                data_file=df, obs_spatial_pattern=p, n_experiments=8,
                base_seed=2025 + rep * 1000))
            jobs.extend((cfg, e, tmp / f"m{rep}" / f"{i}_{e}")
                        for e in range(1, 9))
        return [jobs[k:k + 16] for k in range(0, len(jobs), 16)]

    def homog_batches(rep):
        cfg = ExperimentConfig.from_dict(bench_workload(
            n_experiments=48, base_seed=2025 + rep * 1000))
        jobs = [(cfg, e, tmp / f"h{rep}" / str(e)) for e in range(1, 49)]
        return [jobs[k:k + 16] for k in range(0, len(jobs), 16)]

    orig_exec = batch_engine._execute_job_batch
    stages = []

    def spy_exec(prep, **kw):
        out = orig_exec(prep, **kw)
        stages.append((out["t_setup"], out["t_train"] - out["t_setup"]))
        return out

    batch_engine._execute_job_batch = spy_exec
    for rep in range(args.reps):
        for name, maker in (("mixed", mixed_batches),
                            ("homog", homog_batches)):
            stages.clear()
            t0 = time.time()
            run_job_batches(maker(rep), epochs_chunk=500, lane_width=16)
            wall = time.time() - t0
            su = sum(s[0] for s in stages)
            tr = sum(s[1] for s in stages)
            print(f"[stage-split] rep{rep} {name}: wall={wall:.2f}s "
                  f"setup={su:.2f}s train={tr:.2f}s "
                  f"batches={len(stages)}", flush=True)
    batch_engine._execute_job_batch = orig_exec

    # -- epochs per dataset (the workload term) ------------------------------
    last = args.reps - 1
    for arm in (f"m{last}", f"h{last}"):
        eps = defaultdict(list)
        for f in (tmp / arm).glob("*/results.json"):
            r = json.loads(f.read_text())
            eps[r["config"]["data_file"].split("/")[-1]].append(
                r["n_epochs_run"])
        for df, v in sorted(eps.items()):
            print(f"[epochs] {arm} {df}: n={len(v)} max={max(v)} "
                  f"mean={np.mean(v):.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
