#!/usr/bin/env python
"""Paired A/B of any config override on the bench workload, end metric.

Fits the SAME seeds under a baseline arm and a modified arm (one or more
`key=value` config overrides), so per-seed CRPS deltas are PAIRED — same
masks, same init subsample, same training stream wherever the override
doesn't touch them. This is the measurement tool behind performance knobs
that perturb arithmetic, e.g.:

    # bf16 EM storage in the GMM init (ops/init_centers.py):
    python scripts/ab_paired.py --b init_em_dtype=bfloat16 \
        --out results/ab_em_dtype_r3

    # bf16 trunk activations in the training scan (models/st_interp.py):
    python scripts/ab_paired.py --b train_dtype=bf16 \
        --out results/ab_train_dtype_r3

Values parse as YAML scalars (so `epochs=250` is an int, `lr=1e-3` a
float, `train_dtype=bf16` a string).
"""
from __future__ import annotations

import argparse
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

import numpy as np  # noqa: E402
import yaml  # noqa: E402

from st_dadk_tpu.config import ExperimentConfig  # noqa: E402
from st_dadk_tpu.train.runner import (load_all_results,  # noqa: E402
                                      run_multiple_experiments)
from st_dadk_tpu.utils.io import save_json  # noqa: E402

from st_dadk_tpu.bench_workload import bench_workload  # noqa: E402

# the ONE bench workload (st_dadk_tpu/bench_workload.py) with explicit
# deviations: results are read back per-arm via load_all_results, which
# needs the per-experiment results.json artifacts on disk. NOTE this makes
# arm wall_seconds include artifact IO that bench.py's finalize does not —
# compare arms to each other, not to the headline fits/hour.
BASE = bench_workload(tag="ab_paired", save_artifacts=True)


def _parse_overrides(pairs):
    out = {}
    for p in pairs:
        k, _, v = p.partition("=")
        if not _:
            raise SystemExit(f"override must be key=value, got: {p!r}")
        out[k] = yaml.safe_load(v)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_experiments", type=int, default=16)
    ap.add_argument("--data_file", default=None)
    ap.add_argument("--a", nargs="*", default=[],
                    help="key=value overrides for the BASELINE arm")
    ap.add_argument("--b", nargs="+", required=True,
                    help="key=value overrides for the MODIFIED arm "
                         "(applied on top of the baseline arm's)")
    ap.add_argument("--out", default=str(REPO / "results" / "ab_paired"))
    ap.add_argument("--arms", nargs="+", default=["a", "b"],
                    help="subset of arms to (re)fit; the summary still "
                         "aggregates every completed arm found under --out")
    args = ap.parse_args()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    arm_over = {"a": _parse_overrides(args.a),
                "b": {**_parse_overrides(args.a), **_parse_overrides(args.b)}}

    table = {}
    per_seed = {}
    for arm in ("a", "b"):
        d = dict(BASE, n_experiments=args.n_experiments, **arm_over[arm])
        if args.data_file:
            d["data_file"] = args.data_file
        cdir = out / arm
        cdir.mkdir(parents=True, exist_ok=True)
        wall_cold = None
        if arm in args.arms:
            print(f"\n=== arm {arm}: {arm_over[arm] or 'baseline'} "
                  f"({args.n_experiments} seeds) ===", flush=True)
            # WARMUP: compile/load every program this arm's config needs
            # (fit chunk, init, eval, finalize) in a throwaway run before
            # the timed one. Without this, whichever arm runs first in the
            # process absorbs the compile warmup and every wall
            # comparison is an ordering artifact.
            warm = Path(tempfile.mkdtemp(prefix=f"ab_warm_{arm}_"))
            t0 = time.time()
            try:
                run_multiple_experiments(
                    ExperimentConfig.from_dict(
                        {**d, "base_seed": d.get("base_seed", 2025) + 777000}),
                    warm, engine="vmap")
            finally:
                shutil.rmtree(warm, ignore_errors=True)
            wall_cold = round(time.time() - t0, 1)
            print(f"  arm {arm}: warmup (cold, incl. compile) "
                  f"{wall_cold:.1f}s", flush=True)
        t0 = time.time()
        if arm in args.arms:
            run_multiple_experiments(ExperimentConfig.from_dict(d), cdir,
                                     engine="vmap")
        results = load_all_results(cdir / "experiments", args.n_experiments)
        crps = {r["experiment_id"]: r["test_crps"] for r in results
                if "test_crps" in r}
        rmse = {r["experiment_id"]: r["test_rmse"] for r in results
                if "test_rmse" in r}
        if not crps:
            continue
        per_seed[arm] = {"crps": crps, "rmse": rmse}
        table[arm] = {
            "overrides": arm_over[arm],
            "n": len(crps),
            "test_crps_mean": float(np.mean(list(crps.values()))),
            "test_crps_std": float(np.std(list(crps.values()))),
            "test_rmse_mean": float(np.mean(list(rmse.values()))),
            "wall_seconds": (round(time.time() - t0, 1)
                             if arm in args.arms else None),
            "wall_seconds_cold": wall_cold,
        }
        e = table[arm]
        print(f"  arm {arm}: CRPS {e['test_crps_mean']:.4f} ± "
              f"{e['test_crps_std']:.4f}  RMSE {e['test_rmse_mean']:.4f}",
              flush=True)

    if "a" in per_seed and "b" in per_seed:
        common = sorted(set(per_seed["a"]["crps"]) & set(per_seed["b"]["crps"]))
        deltas = np.array([per_seed["b"]["crps"][i] - per_seed["a"]["crps"][i]
                           for i in common])
        rdeltas = np.array([per_seed["b"]["rmse"][i] - per_seed["a"]["rmse"][i]
                            for i in common])
        table["paired"] = {
            "n_pairs": len(common),
            "crps_delta_mean": float(deltas.mean()),
            "crps_delta_std": float(deltas.std()),
            "crps_delta_sigma": float(abs(deltas.mean())
                                      / max(deltas.std()
                                            / np.sqrt(len(deltas)), 1e-12)),
            "rmse_delta_mean": float(rdeltas.mean()),
        }
        p = table["paired"]
        print(f"\npaired b-a CRPS delta = {p['crps_delta_mean']:+.5f} "
              f"± {p['crps_delta_std']:.5f} over {p['n_pairs']} seeds "
              f"({p['crps_delta_sigma']:.2f} sigma of the mean)")

    save_json(table, out / "ab_summary.json")
    print(f"[OK] wrote {out / 'ab_summary.json'}")


if __name__ == "__main__":
    main()
