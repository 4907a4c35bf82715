#!/usr/bin/env python
"""Competition-submission pipeline: train on a *_train.csv, predict the
matching *_test.csv rows, write a submission, and (when the family's
-solutions.csv is available) score it against the competition ground truth.

This exercises the second workload style the reference carries
(kaust_loader.py:79-175 pair loading + predictions_to_csv :518-565) end to
end with the interpolation model: the test rows' (x, y, t) become prediction
points for the trained field.

Example:
    python scripts/predict_submission.py --family data/2a/2a_8 \
        --epochs 300 --out submission_2a_8.csv
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

import numpy as np
import pandas as pd

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.kaust import load_kaust_csv
from st_dadk_tpu.dataio.arrays import PointSet
from st_dadk_tpu.models.st_interp import init_model, spec_from_config
from st_dadk_tpu.ops.init_centers import (DATA_ADAPTIVE_INIT_METHODS,
                                          init_spatial_centers)
from st_dadk_tpu.train.loop import fit, predict
import jax


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--family", type=str, required=True,
                        help="dataset stem, e.g. data/2a/2a_8 (expects "
                             "<stem>_train.csv and <stem>_test.csv)")
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=2025)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--solution_column", type=int, default=None,
                        help="column (1-based z<k>) in the family's "
                             "-solutions.csv to score against; default: the "
                             "dataset index from the stem")
    args = parser.parse_args()

    cfg = ExperimentConfig.from_yaml(args.config)
    if args.epochs:
        cfg = cfg.replace(epochs=args.epochs)

    stem = Path(args.family)
    resolve = lambda p: ExperimentConfig(data_file=str(p)).resolve_data_file()
    train_path = resolve(f"{stem}_train.csv")
    test_path = resolve(f"{stem}_test.csv")
    if not train_path.exists() or not test_path.exists():
        sys.exit(f"missing {train_path} / {test_path}")

    print(f"[INFO] training on {train_path}")
    z_train, z_test, coords, site_to_idx, meta = load_kaust_csv(
        train_path, test_path, normalize=True)
    T_tr = z_train.shape[0]

    # all observed train points -> train/valid split 90/10 at random
    tt, ss = np.nonzero(~np.isnan(z_train))
    y = z_train[tt, ss]
    denom = max(meta["T_te_start"] + z_test.shape[0] - 2, 1)
    t_norm = (tt / denom).astype(np.float32)
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(y))
    n_tr = int(0.9 * len(y))

    def ps(idx):
        return PointSet(coords=coords[ss[idx]].astype(np.float32),
                        t=t_norm[idx][:, None],
                        y=y[idx].astype(np.float32)[:, None],
                        w=np.ones(len(idx), np.float32), n_real=len(idx))

    train_ps, valid_ps = ps(perm[:n_tr]), ps(perm[n_tr:])

    train_coords = None
    if cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS:
        train_coords = train_ps.coords
    np.random.seed(args.seed)
    centers, bw = init_spatial_centers(cfg.spatial_init_method,
                                       cfg.k_spatial_centers, train_coords,
                                       key=jax.random.PRNGKey(args.seed))
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(args.seed), spec,
                                centers, bw)
    t0 = time.time()
    result = fit(cfg, spec, params, consts, train_ps, valid_ps,
                 seed=args.seed, verbose=True)
    print(f"[INFO] trained {result.n_epochs_run} epochs in "
          f"{time.time()-t0:.1f}s, best val loss {result.best_val:.5f}")

    # predict the test rows directly at their (x, y, t)
    df_test = pd.read_csv(test_path)
    df_test.columns = [c.strip().strip('"') for c in df_test.columns]
    test_coords = df_test[["x", "y"]].to_numpy(np.float32)
    if "t" in df_test.columns:
        t_test = ((df_test["t"].to_numpy(np.float32) - 1) / denom)[:, None]
    else:
        t_test = np.zeros((len(df_test), 1), np.float32)
    preds = predict(spec, result.params, consts, test_coords, t_test)
    if cfg.regression_type == "multi-quantile":
        preds = preds[:, len(cfg.quantile_levels) // 2]
    else:
        preds = preds[:, 0]
    z_hat = preds * meta["z_std"] + meta["z_mean"]

    out = args.out or f"submission_{stem.name}.csv"
    pd.DataFrame({"z": z_hat}).to_csv(out, index=False)
    print(f"[INFO] submission -> {out}")

    # score against competition ground truth when available
    family_dir = train_path.parent
    fam = stem.name.split("_")[0]
    ds_idx = args.solution_column or int(stem.name.split("_")[1])
    sol_path = family_dir / f"{fam}-solutions.csv"
    if sol_path.exists():
        sol = pd.read_csv(sol_path)
        col = f"z{ds_idx}"
        if col in sol.columns and len(sol) == len(z_hat):
            y_true = sol[col].to_numpy(np.float64)
            rmse = float(np.sqrt(np.mean((z_hat - y_true) ** 2)))
            mae = float(np.mean(np.abs(z_hat - y_true)))
            print(f"[SCORE] vs {sol_path.name}:{col}  RMSE={rmse:.6f}  "
                  f"MAE={mae:.6f}")
        else:
            print(f"[WARN] cannot score: column {col} or row count mismatch")
    else:
        print(f"[INFO] no solutions file at {sol_path}")


if __name__ == "__main__":
    main()
