#!/usr/bin/env python
"""Forecasting-workload pipeline (sub-competition 2's ORIGINAL task):
train a multi-horizon forecaster on sliding windows of <stem>_train.csv
(t = 1..T_tr), forecast the test horizon (t = T_tr+1 ..) at the test sites,
write a submission, and score it against the family's -solutions.csv.

This is the consumer of the KAUSTWindowDataset workload style
(st_dadk_tpu/dataio/windows.py; reference stnf/dataio/kaust_loader.py:237-565
incl. prepare_test_context + predictions_to_csv), which the reference itself
carries without a trainer.

Example:
    python scripts/forecast_submission.py --family data/2a/2a_8
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

import jax
import numpy as np
import pandas as pd

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.kaust import load_kaust_csv
from st_dadk_tpu.dataio.windows import (build_window_dataset,
                                        prepare_test_context,
                                        train_valid_window_split)
from st_dadk_tpu.models.forecaster import (ForecastSpec, ForecastData,
                                           fit_forecaster, forward_forecaster,
                                           init_forecaster, rows_from_windows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", type=str, required=True,
                    help="dataset stem, e.g. data/2a/2a_8")
    ap.add_argument("--L", type=int, default=20, help="context length")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=2025)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    stem = Path(args.family)
    resolve = lambda p: ExperimentConfig(data_file=str(p)).resolve_data_file()
    train_path = resolve(f"{stem}_train.csv")
    test_path = resolve(f"{stem}_test.csv")
    if not train_path.exists() or not test_path.exists():
        sys.exit(f"missing {train_path} / {test_path}")

    z_train, z_test, coords, site_to_idx, meta = load_kaust_csv(
        train_path, test_path, normalize=True)
    T_tr, S = z_train.shape
    H = z_test.shape[0]
    T_total = T_tr + H
    print(f"[INFO] {train_path.name}: T_tr={T_tr} S={S}; horizon H={H}")

    # sites with a complete history can be forecast directly
    obs_sites = np.where(~np.isnan(z_train).any(axis=0))[0]
    z_filled = np.nan_to_num(z_train, nan=0.0)
    spec = ForecastSpec(L=args.L, H=H)

    train_ds, valid_ds = train_valid_window_split(
        z_filled, coords, obs_sites, spec.L, spec.H, val_ratio=0.2)
    tr_rows = rows_from_windows(train_ds, T_total)
    va_rows = rows_from_windows(valid_ds, T_total)
    print(f"[INFO] windows: {len(train_ds)} train / {len(valid_ds)} valid "
          f"x {len(obs_sites)} sites -> {tr_rows.y_hist.shape[0]} samples")

    params, consts = init_forecaster(jax.random.PRNGKey(args.seed), spec)
    t0 = time.time()
    best_p, hist = fit_forecaster(spec, params, consts, tr_rows, va_rows,
                                  epochs=args.epochs,
                                  batch_size=args.batch_size, lr=args.lr,
                                  seed=args.seed, verbose=True)
    print(f"[INFO] trained in {time.time()-t0:.1f}s "
          f"({hist['n_epochs_run']} epochs)")

    # forecast from the last-L context (ref prepare_test_context)
    ctx = prepare_test_context(z_filled, coords, obs_sites, spec.L)
    rows = ForecastData(
        y_hist=ctx["y_hist_obs"][0, :, :, 0].T.astype(np.float32),
        coords=ctx["obs_coords"][0],
        t0=np.full((len(obs_sites), 1), T_tr / max(T_total - 1, 1),
                   np.float32),
        y_fut=np.zeros((len(obs_sites), H), np.float32))
    preds = np.asarray(forward_forecaster(
        spec, jax.tree_util.tree_map(np.asarray, best_p), consts,
        rows.y_hist, rows.coords, rows.t0))            # (n_obs, H)
    preds = preds * meta["z_std"] + meta["z_mean"]

    # map forecasts onto the test rows via the site index
    df_test = pd.read_csv(test_path)
    df_test.columns = [c.strip().strip('"') for c in df_test.columns]
    site_idx = np.array([site_to_idx[(float(r.x), float(r.y))]
                         for r in df_test.itertuples()])
    obs_pos = {int(s): i for i, s in enumerate(obs_sites)}
    t_idx = df_test["t"].to_numpy(np.int64) - meta["T_te_start"]
    z_hat = np.empty(len(df_test), np.float64)
    fallback = float(np.nanmean(z_train) * meta["z_std"] + meta["z_mean"])
    for i, (s, ti) in enumerate(zip(site_idx, t_idx)):
        pos = obs_pos.get(int(s))
        z_hat[i] = preds[pos, ti] if pos is not None else fallback

    out = args.out or f"forecast_submission_{stem.name}.csv"
    pd.DataFrame({"z": z_hat}).to_csv(out, index=False)
    print(f"[INFO] submission -> {out}")

    fam = stem.name.split("_")[0]
    ds_idx = int(stem.name.split("_")[1])
    sol_path = train_path.parent / f"{fam}-solutions.csv"
    if sol_path.exists():
        sol = pd.read_csv(sol_path)
        col = f"z{ds_idx}"
        if col in sol.columns and len(sol) == len(z_hat):
            y_true = sol[col].to_numpy(np.float64)
            rmse = float(np.sqrt(np.mean((z_hat - y_true) ** 2)))
            mae = float(np.mean(np.abs(z_hat - y_true)))
            # persistence baseline: last observed value per site
            last = z_filled[-1] * meta["z_std"] + meta["z_mean"]
            z_pers = np.array([last[s] for s in site_idx])
            rmse_p = float(np.sqrt(np.mean((z_pers - y_true) ** 2)))
            print(f"[SCORE] vs {sol_path.name}:{col}  RMSE={rmse:.6f}  "
                  f"MAE={mae:.6f}  (persistence RMSE={rmse_p:.6f})")
        else:
            print(f"[WARN] cannot score: column {col} or row count mismatch")


if __name__ == "__main__":
    main()
