#!/usr/bin/env python
"""Headline benchmark: experiment-fit throughput on the reference workload.

Workload = the reference's default config (configs/config_st_interp.yaml of
STLABTW/ST-DADK) on a 2a_8-shaped field (T=100, S=1000) generated in the
repository (st_dadk_tpu/dataio/synth.py), multi-quantile
tau={.05,.25,.5,.75,.95}, GMM-initialized learnable Wendland basis, AdamW
2e-2 + warmup/cosine + EMA, 500 epochs max with patience 50 — i.e. one full
DA-STDK fit. We stream vmapped batches of M fits through the GPU with
finalize pipelined against the next batch's training, and report
steady-state fits/hour. The first jax device must be a GPU (no CPU
fallback); the training field is generated in the repository if missing.

Measurement protocol: FIVE independent windows, each >= 90 s of whole
batches, median window reported with the per-window spread; window lengths
and rates are recorded in bench_details.json.

Baseline: the same workload measured with the actual reference code on a
CPU = 35.0 fits/hour single-process (baselines/reference_cpu.json;
3 fits, mean 102.8 s/fit). The reference's parallel mode is joblib
n_jobs=10, so vs_baseline divides by 10x the single-process rate — an
optimistic proxy for the reference (perfect scaling, 10 cores).

Prints ONE JSON line:
    {"metric": "fits_per_hour", "value": ..., "unit": "fits/hour",
     "vs_baseline": ...}
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BASELINE_FITS_PER_HOUR_1CORE = 35.0
BASELINE_JOBLIB10_PROXY = BASELINE_FITS_PER_HOUR_1CORE * 10.0
MIN_WINDOW_SECONDS = float(os.environ.get("BENCH_WINDOW_SECONDS", 90.0))
N_WINDOWS = int(os.environ.get("BENCH_WINDOWS", 5))
# non-default protocols (e.g. the long-horizon stability check) write their
# evidence elsewhere so the headline bench_details.json is never clobbered
DETAILS_PATH = Path(os.environ.get("BENCH_DETAILS",
                                   str(REPO / "bench_details.json")))
# BENCH_LANE_WIDTH=w splits each M-fit workload into pipelined w-lane
# batches — the same policy run_lane_jobs applies in real sweeps
# (LANES_PER_DEVICE). 0 = one M-lane batch per dispatch (the raw lane-width
# measurement).
LANE_WIDTH = int(os.environ.get("BENCH_LANE_WIDTH", 0))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import numpy as np

    from st_dadk_tpu.utils.platform import enable_compile_cache, require_gpu
    dev = require_gpu()
    log(f"[bench] device {dev['kind']} x{dev['count']}; "
        f"nvidia-smi: {dev['nvidia_smi']}")
    enable_compile_cache()

    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.dataio.synth import ensure_2a8_field
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.train.batch_engine import run_job_batch, run_job_batches

    M = int(sys.argv[1]) if len(sys.argv) > 1 else 16

    # ablation hook (same contract as profile_batch's
    # ST_DADK_PROFILE_OVERRIDES): BENCH_OVERRIDES='{"scan_unroll": 4}'
    # measures the workload with config overrides; the headline protocol
    # is the bare default.
    overrides = json.loads(os.environ.get("BENCH_OVERRIDES", "{}"))
    if overrides and DETAILS_PATH == REPO / "bench_details.json":
        log("[bench] WARNING: BENCH_OVERRIDES set without a non-default "
            "BENCH_DETAILS path — overwriting the headline evidence file "
            "with an overridden-workload run")
    base = bench_workload(**overrides)
    ensure_2a8_field()

    def jobs_for(seed: int, out: Path):
        cfg = ExperimentConfig.from_dict({**base, "base_seed": seed})
        return [(cfg, i, out / str(i)) for i in range(1, M + 1)]

    tmp = Path(tempfile.mkdtemp(prefix="stdadk_bench_"))
    try:
        # warmup: compiles the whole-fit + init + eval programs, at the
        # WIDTH THE WINDOWS RUN: under BENCH_LANE_WIDTH the measured batches
        # are lane_width-lane programs, so warming only the M-lane shape
        # would leave window 0 paying the split program's compile. Then one
        # more warm batch.
        if LANE_WIDTH and LANE_WIDTH < M:
            # every distinct chunk width the split produces (incl. a
            # ragged tail, e.g. M=24 w=16 -> widths {16, 8})
            widths = sorted({len(c) for c in (
                list(range(M))[i:i + LANE_WIDTH]
                for i in range(0, M, LANE_WIDTH))}, reverse=True)
        else:
            widths = [M]
        log(f"[bench] warmup batches (widths {widths}) — compiling...")
        for wi, seed in enumerate((9999, 9998)):
            for w in widths:
                t0 = time.time()
                warm_jobs = jobs_for(seed, tmp / f"warm{wi}_{w}")[:w]
                run_job_batch(warm_jobs, epochs_chunk=500)
                log(f"[bench] warmup batch {wi} (width {w}) "
                    f"in {time.time()-t0:.1f}s")

        windows = []
        results = None
        seed_base = 2025
        for wi in range(N_WINDOWS):
            t0 = time.time()

            def gen(wi=wi, t0=t0):
                # stream whole batches (pipelined train/finalize inside
                # run_job_batches) until the window is long enough
                bi = 0
                while True:
                    jobs = jobs_for(seed_base + wi * 100000 + bi * 1000,
                                    tmp / f"w{wi}b{bi}")
                    if LANE_WIDTH and LANE_WIDTH < len(jobs):
                        for c in range(0, len(jobs), LANE_WIDTH):
                            yield jobs[c:c + LANE_WIDTH]
                    else:
                        yield jobs
                    bi += 1
                    if time.time() - t0 >= MIN_WINDOW_SECONDS:
                        return

            window_results = run_job_batches(gen(), epochs_chunk=500)
            wall = time.time() - t0
            fits = len(window_results)
            rate = fits / wall * 3600.0
            windows.append({"fits": fits, "wall_seconds": wall,
                            "fits_per_hour": rate})
            results = window_results
            log(f"[bench] window {wi}: {fits} fits in {wall:.1f}s "
                f"-> {rate:.1f} fits/hr")
            # incremental dump: if a later window stalls, the completed
            # windows' evidence survives on disk
            with open(DETAILS_PATH, "w") as f:
                json.dump({"M": M, "overrides": overrides,
                           "windows": windows, "partial": True},
                          f, indent=2)

        rates = sorted(w["fits_per_hour"] for w in windows)
        fits_per_hour = rates[len(rates) // 2]          # median window
        spread_pct = ((rates[-1] - rates[0]) / fits_per_hour * 50.0
                      if fits_per_hour else 0.0)        # +/- half-range %

        crps = [r.get("test_crps") for r in results]
        rmse = [r.get("test_rmse") for r in results]
        log(f"[bench] median window: {fits_per_hour:.1f} fits/hr "
            f"(spread +/-{spread_pct:.1f}% over {len(rates)} windows, "
            f"range {rates[0]:.0f}-{rates[-1]:.0f})")
        log(f"[bench] test CRPS mean={np.mean(crps):.4f}; "
            f"test RMSE mean={np.mean(rmse):.4f}")

        details = {
            "device": dev,
            "M": M,
            "overrides": overrides,
            "lane_width": LANE_WIDTH or M,
            "protocol": f"median of {N_WINDOWS} windows, each >= "
                        f"{MIN_WINDOW_SECONDS:.0f}s of whole pipelined batches",
            "windows": windows,
            "fits_per_hour": fits_per_hour,
            "window_spread_pct": round(spread_pct, 2),
            "test_crps_last_window": crps, "test_rmse_last_window": rmse,
            "baseline_1core_fits_per_hour": BASELINE_FITS_PER_HOUR_1CORE,
            "baseline_joblib10_proxy": BASELINE_JOBLIB10_PROXY,
        }
        with open(DETAILS_PATH, "w") as f:
            json.dump(details, f, indent=2)

        print(json.dumps({
            "metric": "fits_per_hour",
            "value": round(fits_per_hour, 2),
            "unit": "fits/hour",
            "vs_baseline": round(fits_per_hour / BASELINE_JOBLIB10_PROXY, 2),
            "device": {"platform": dev["platform"], "kind": dev["kind"],
                       "count": dev["count"]},
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
