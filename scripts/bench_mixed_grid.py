#!/usr/bin/env python
"""Drift-controlled throughput for the PRODUCTION grid-search workload.

Measures the heterogeneous mixed-config grid ("stacked grid search"):
3 data files x 2 observation patterns x 8 repeats
= 48 fits spanning 6 distinct configs, run end-to-end through
`run_grid_search` (vmap engine) including bucketing, per-config
aggregation, and the grid CSV contract. This is the workload the
reference's joblib pool exists for (run_grid_search.py:331-387) and the
grid-search fits/hour metric.

Drift control (same rationale as scripts/ab_interleaved.py): the rate
drifts across sessions, so the mixed-grid rate is only interpretable against a homogeneous calibration arm measured in the SAME
process, alternating rep-by-rep. Arm a = the mixed grid (48 fits);
arm b = the homogeneous headline workload streamed at the same lane count
(3 pipelined 16-lane batches of 2a_8 repeats = 48 fits). The paired ratio
a/b is the heterogeneity cost, independent of session drift.

Usage:
    python scripts/bench_mixed_grid.py [--reps 5] [--out results/dir]
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)

apply_platform_env()
enable_compile_cache()

# the 48-fit mixed grid: the headline workload's model/loop hyperparameters swept over data files and
# observation patterns — 6 configs whose lanes stack into one program
PARAM_GRID = {
    "data_file": ["data/2a/2a_7.csv", "data/2a/2a_8.csv", "data/2a/2a_9.csv"],
    "obs_spatial_pattern": ["corner", "uniform"],
}
N_REPEATS = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved (grid, homogeneous) rep pairs to time")
    ap.add_argument("--out", default=None,
                    help="write summary json under this dir")
    ap.add_argument("--grid-overrides", default="{}",
                    help="JSON config overrides applied to the GRID arm only "
                         "(the homogeneous arm stays the headline default so "
                         "the paired ratio reads as 'grid policy vs headline')"
                         ", e.g. '{\"early_stop_min_rel_delta\": 0.001}'")
    ap.add_argument("--sweep-thresholds", default=None,
                    help="comma list of early_stop_min_rel_delta values; runs "
                         "ONE grid per value and reports wall / stop-epoch / "
                         "CRPS per config instead of the paired protocol")
    args = ap.parse_args()

    import numpy as np

    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.sweep.grid import run_grid_search
    from st_dadk_tpu.train.batch_engine import run_job_batches

    base = bench_workload(n_experiments=N_REPEATS)
    grid_overrides = json.loads(args.grid_overrides)
    n_fits = (len(PARAM_GRID["data_file"])
              * len(PARAM_GRID["obs_spatial_pattern"]) * N_REPEATS)

    tmp = Path(tempfile.mkdtemp(prefix="bench_mixed_grid_"))

    def grid_rep(rep: int, keep: bool = False, overrides=None):
        out = tmp / f"grid{rep}"
        t0 = time.time()
        results = run_grid_search({**base, **(grid_overrides
                                              if overrides is None
                                              else overrides),
                                   "base_seed": 2025 + rep * 1000},
                                  PARAM_GRID, out, engine="vmap")
        wall = time.time() - t0
        ok = sum(1 for r in results if r["status"] == "success")
        assert ok == len(results) == 6, [r["status"] for r in results]
        if keep:
            return wall, out, results
        shutil.rmtree(out, ignore_errors=True)
        return wall

    def homog_rep(rep: int) -> float:
        cfg = ExperimentConfig.from_dict(
            {**base, "base_seed": 7025 + rep * 1000})
        jobs = [(cfg, i, tmp / f"homog{rep}" / str(i))
                for i in range(1, n_fits + 1)]
        batches = [jobs[i:i + 16] for i in range(0, n_fits, 16)]
        t0 = time.time()
        res = run_job_batches(batches, epochs_chunk=500, lane_width=16)
        wall = time.time() - t0
        assert len(res) == n_fits
        shutil.rmtree(tmp / f"homog{rep}", ignore_errors=True)
        return wall

    def scan_grid_out(out: Path):
        """Per-config (tag) stop-epoch + CRPS scrape from results.json."""
        per_cfg = {}
        for cfg_dir in sorted(p for p in out.iterdir() if p.is_dir()):
            rows = []
            for rj in sorted(cfg_dir.glob("experiments/*/results.json")):
                with open(rj) as f:
                    r = json.load(f)
                rows.append((r.get("n_epochs_run"), r.get("test_crps")))
            if rows:
                ep = [x[0] for x in rows if x[0] is not None]
                cr = [x[1] for x in rows if x[1] is not None]
                per_cfg[cfg_dir.name] = {
                    "epochs_mean": round(float(np.mean(ep)), 1),
                    "epochs_max": int(np.max(ep)),
                    "test_crps_mean": round(float(np.mean(cr)), 4),
                    "test_crps_std": round(float(np.std(cr)), 4),
                }
        return per_cfg

    if args.sweep_thresholds is not None:
        # threshold characterization: one 48-fit grid per value; the point
        # is the stop-epoch distribution (does the plateau stop actually
        # fire on the smooth-field critical-path configs?) and a first-look
        # CRPS delta, not a drift-controlled wall (the walls differ >20%
        # when the stop fires, far above session drift)
        try:
            sweep = []
            for di, d in enumerate(float(x) for x in
                                   args.sweep_thresholds.split(",")):
                ov = dict(grid_overrides, early_stop_min_rel_delta=d)
                w_warm = grid_rep(900 + di, overrides=ov)   # compile pass
                wall, out, _ = grid_rep(0, keep=True, overrides=ov)
                per_cfg = scan_grid_out(out)
                shutil.rmtree(out, ignore_errors=True)
                rate = n_fits / wall * 3600
                sweep.append({"min_rel_delta": d, "wall_seconds":
                              round(wall, 2), "warm_wall_seconds":
                              round(w_warm, 2),
                              "fits_per_hour": round(rate, 1),
                              "per_config": per_cfg})
                print(f"\nd={d:g}: {wall:.2f}s ({rate:,.0f} fits/hr)")
                for tag, v in per_cfg.items():
                    print(f"  {tag:<42} epochs {v['epochs_mean']:>6.1f} "
                          f"(max {v['epochs_max']:>3}) crps "
                          f"{v['test_crps_mean']:.4f}"
                          f"+/-{v['test_crps_std']:.4f}")
            if args.out:
                outp = Path(args.out)
                outp.mkdir(parents=True, exist_ok=True)
                (outp / "threshold_sweep.json").write_text(
                    json.dumps({"param_grid": PARAM_GRID,
                                "n_repeats": N_REPEATS, "sweep": sweep},
                               indent=2))
                print(f"[OK] wrote {outp / 'threshold_sweep.json'}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0

    try:
        # warm both arms twice (compile + first-run costs); they share the
        # 16-lane compiled program, but the grid arm additionally loads the
        # 2a_7/2a_9 CSVs into the process cache on its first pass
        for arm, fn in (("grid", grid_rep), ("homog", homog_rep),
                        ("grid", grid_rep), ("homog", homog_rep)):
            w = fn(999)
            print(f"  warmup {arm}: {w:.1f}s", flush=True)

        walls = {"grid": [], "homog": []}
        for p in range(args.reps):
            for arm, fn in (("grid", grid_rep), ("homog", homog_rep)) \
                    if p % 2 == 0 else (("homog", homog_rep),
                                        ("grid", grid_rep)):
                walls[arm].append(fn(p))
            g, h = walls["grid"][-1], walls["homog"][-1]
            print(f"  pair {p}: grid={g:.2f}s homog={h:.2f}s "
                  f"grid/homog={g / h:.3f}", flush=True)

        wg = np.asarray(walls["grid"])
        wh = np.asarray(walls["homog"])
        ratios = wg / wh
        rate_g = n_fits / float(np.median(wg)) * 3600
        rate_h = n_fits / float(np.median(wh)) * 3600
        summary = {
            "n_fits": n_fits, "n_configs": 6, "reps": args.reps,
            "grid_overrides": grid_overrides,
            "param_grid": PARAM_GRID, "n_repeats": N_REPEATS,
            "wall_grid": [round(float(x), 3) for x in wg],
            "wall_homog": [round(float(x), 3) for x in wh],
            "fits_per_hour_grid": round(rate_g, 1),
            "fits_per_hour_homog_calibration": round(rate_h, 1),
            "paired_ratio_grid_over_homog_median":
                round(float(np.median(ratios)), 4),
            "paired_ratio_p10_p90": [
                round(float(np.percentile(ratios, q)), 4) for q in (10, 90)],
        }
        print(f"\nmixed grid: {rate_g:,.0f} fits/hr "
              f"(homogeneous calibration in-session: {rate_h:,.0f}); "
              f"paired heterogeneity cost x"
              f"{summary['paired_ratio_grid_over_homog_median']:.3f}")
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / "mixed_grid_summary.json").write_text(
                json.dumps(summary, indent=2))
            print(f"[OK] wrote {out / 'mixed_grid_summary.json'}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
