#!/usr/bin/env python
"""Score the framework on EVERY KAUST competition family against the official
ground truth (`data/<fam>/<fam>-solutions.csv`).

Two evaluation modes, chosen per dataset by what the snapshot ships
(SURVEY.md §6: several train files were withheld by the competition):

  train-mode   <stem>_train.csv exists (1a, 2a, 3a): train on it, predict the
               official test rows, score vs the solutions column.
  splitsol     only <stem>_test.csv + solutions exist (1b, 3b): the solutions
               ARE a real field realization at the test sites, so hold out a
               seeded 10% of those sites, train on the other 90%, and score
               the held-out sites vs ground truth. Real-field evidence, just
               on a site split the competition didn't define.

2b ships neither train files NOR a solutions file (verified: data/2b/ holds
only *_test.csv with empty z), so it cannot be scored against ground truth at
all — its protocol evidence stays on the documented synthetic reconstruction
(scripts/synthesize_2b.py).

Bivariate families (3a/3b carry two correlated fields z1/z2 per dataset) fit
one model per field; solutions column = z_{2(i-1)+j} for dataset i field j
(mapping verified by nearest-neighbor correlation against the train fields).

Fits are multi-quantile (the reference default protocol), so the held-out
scores include CRPS next to RMSE/MAE. Reference counterpart: the submission
pipeline kaust_loader.py:483-565 + the competition's RMSE/MAE metric.

Usage:
    python scripts/score_families.py --families 1a 1b 2a 3a 3b \
        --epochs 300 --out results/family_scores_r3
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

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from st_dadk_tpu.config import ExperimentConfig  # noqa: E402
from st_dadk_tpu.dataio.arrays import PointSet  # noqa: E402
from st_dadk_tpu.models.st_interp import init_model, spec_from_config  # noqa: E402
from st_dadk_tpu.ops.init_centers import (  # noqa: E402
    DATA_ADAPTIVE_INIT_METHODS, init_spatial_centers)
from st_dadk_tpu.ops.losses import compute_crps_multi_quantile  # noqa: E402
from st_dadk_tpu.train.loop import fit, predict  # noqa: E402

REF_DATA = Path("/root/reference/data")


def _clean(df: pd.DataFrame) -> pd.DataFrame:
    df.columns = [c.strip().strip('"') for c in df.columns]
    return df.drop(columns=[c for c in df.columns if c.startswith("Unnamed")])


def _pointset(coords, t, y, w=None):
    n = len(y)
    return PointSet(coords=np.asarray(coords, np.float32),
                    t=np.asarray(t, np.float32).reshape(n, 1),
                    y=np.asarray(y, np.float32).reshape(n, 1),
                    w=np.ones(n, np.float32) if w is None else w, n_real=n)


def fit_and_predict(cfg: ExperimentConfig, seed: int,
                    train_xyt, train_z, eval_xyt):
    """Train one multi-quantile model on (coords, t_norm, z) points and
    return (Q,) quantile predictions at eval points, in the ORIGINAL scale."""
    mu, sd = float(np.mean(train_z)), float(np.std(train_z))
    sd = sd if sd > 0 else 1.0
    zn = (train_z - mu) / sd

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(zn))
    n_tr = int(0.9 * len(zn))
    tr_idx, va_idx = perm[:n_tr], perm[n_tr:]
    coords, t = train_xyt
    train_ps = _pointset(coords[tr_idx], t[tr_idx], zn[tr_idx])
    valid_ps = _pointset(coords[va_idx], t[va_idx], zn[va_idx])

    train_coords = None
    if cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS:
        train_coords = train_ps.coords
    np.random.seed(seed)
    centers, bw = init_spatial_centers(cfg.spatial_init_method,
                                       cfg.k_spatial_centers, train_coords,
                                       key=jax.random.PRNGKey(seed))
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(seed), spec, centers, bw)
    res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=seed)

    ecoords, et = eval_xyt
    preds = predict(spec, res.params, consts,
                    np.asarray(ecoords, np.float32),
                    np.asarray(et, np.float32))
    return preds * sd + mu, res.n_epochs_run


def score(preds: np.ndarray, y_true: np.ndarray, qlevels) -> dict:
    med = preds[:, len(qlevels) // 2]
    out = {
        "rmse": float(np.sqrt(np.mean((med - y_true) ** 2))),
        "mae": float(np.mean(np.abs(med - y_true))),
        "crps": compute_crps_multi_quantile(preds, y_true, list(qlevels)),
    }
    return out


def iter_jobs(families, data_dir: Path, synth_dir: Path = None):
    """Yield (name, mode, train_csv, test_csv, sol_col) per fit.

    With synth_dir set, families whose train files the snapshot withholds
    (1b, 3b) additionally yield mode='synth' jobs at the TRUE competition
    scale: train on the reconstructed `<synth_dir>/<fam>/<fam>_<i>.csv`
    (scripts/synthesize_1b3b.py — covariance fitted to the real solutions
    field, GRF sampled at n_train synthetic sites AND the official test
    sites), score at the official test coordinates against the SAME
    realization's values there (`_synthsol.csv`). Exercises the b-families
    at 900k/450k train points; real-field accuracy stays with splitsol."""
    for fam in families:
        fam_dir = data_dir / fam
        if synth_dir is not None:
            sdir = synth_dir / fam
            for train_csv in sorted(sdir.glob(f"{fam}_*.csv")):
                stem = train_csv.stem
                if not stem.split("_")[-1].isdigit():
                    continue
                i = int(stem.split("_")[-1])
                ssol = sdir / f"{fam}_{i}_synthsol.csv"
                test_csv = fam_dir / f"{fam}_{i}_test.csv"
                if not (ssol.exists() and test_csv.exists()):
                    continue
                fields = ("z1", "z2") if fam in ("3a", "3b") else ("z",)
                for f in fields:
                    name = f"{fam}_{i}" + (f".{f}" if len(fields) > 1 else "")
                    yield dict(name=name + "@synth", fam=fam, mode="synth",
                               field=f, train_csv=train_csv,
                               test_csv=test_csv, sol_path=ssol, sol_col=f)
        sol_path = fam_dir / f"{fam}-solutions.csv"
        if not sol_path.exists():
            print(f"[WARN] {fam}: no solutions file; skipping "
                  f"(2b ships no ground truth at all)")
            continue
        sol_cols = [c for c in _clean(pd.read_csv(sol_path, nrows=1)).columns
                    if c != "id"]
        tests = sorted(fam_dir.glob(f"{fam}_*_test.csv"),
                       key=lambda p: int(p.stem.split("_")[1]))
        bivariate = fam in ("3a", "3b")
        for test_csv in tests:
            i = int(test_csv.stem.split("_")[1])
            train_csv = fam_dir / f"{fam}_{i}_train.csv"
            fields = ("z1", "z2") if bivariate else ("z",)
            for j, f in enumerate(fields):
                col = f"z{2 * (i - 1) + j + 1}" if bivariate else f"z{i}"
                if col not in sol_cols:
                    continue
                mode = "train" if train_csv.exists() else "splitsol"
                name = f"{fam}_{i}" + (f".{f}" if bivariate else "")
                yield dict(name=name, fam=fam, mode=mode, field=f,
                           train_csv=train_csv, test_csv=test_csv,
                           sol_path=sol_path, sol_col=col)


def run_job(job, cfg: ExperimentConfig, seed: int, holdout: float):
    test = _clean(pd.read_csv(job["test_csv"]))
    sol = _clean(pd.read_csv(job["sol_path"]))
    y_sol = sol[job["sol_col"]].to_numpy(np.float64)
    has_t = "t" in test.columns

    def t_norm(tvals, t_max):
        return (np.asarray(tvals, np.float64) - 1.0) / max(t_max - 1.0, 1.0)

    if job["mode"] in ("train", "synth"):
        tr = _clean(pd.read_csv(job["train_csv"]))
        zcol = job["field"] if job["field"] in tr.columns else "z"
        t_max = float(max(tr["t"].max(), test["t"].max())) if has_t else 1.0
        train_xyt = (tr[["x", "y"]].to_numpy(np.float64),
                     t_norm(tr["t"], t_max) if has_t else np.zeros(len(tr)))
        eval_xyt = (test[["x", "y"]].to_numpy(np.float64),
                    t_norm(test["t"], t_max) if has_t else np.zeros(len(test)))
        preds, n_ep = fit_and_predict(cfg, seed, train_xyt,
                                      tr[zcol].to_numpy(np.float64), eval_xyt)
        return score(preds, y_sol, cfg.quantile_levels), len(tr), len(test), n_ep

    # splitsol: the solutions field at the official test sites, 90/10 split
    assert len(test) == len(y_sol), "solutions/test row mismatch"
    xy = test[["x", "y"]].to_numpy(np.float64)
    tv = t_norm(test["t"], float(test["t"].max())) if has_t \
        else np.zeros(len(test))
    rng = np.random.default_rng(seed + 777)
    perm = rng.permutation(len(y_sol))
    n_hold = int(holdout * len(y_sol))
    hold, tr_i = perm[:n_hold], perm[n_hold:]
    preds, n_ep = fit_and_predict(cfg, seed, (xy[tr_i], tv[tr_i]),
                                  y_sol[tr_i], (xy[hold], tv[hold]))
    return score(preds, y_sol[hold], cfg.quantile_levels), \
        len(tr_i), n_hold, n_ep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", nargs="+",
                    default=["1a", "1b", "2a", "3a", "3b"])
    ap.add_argument("--config", default=str(REPO / "configs" /
                                            "config_st_interp.yaml"))
    ap.add_argument("--data_dir", default=str(REF_DATA))
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seed", type=int, default=2025)
    ap.add_argument("--holdout", type=float, default=0.1)
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to dataset names, e.g. 2a_8 3a_1.z2")
    ap.add_argument("--synth_data", default=None,
                    help="repo data/ tree with synthesize_1b3b.py output; "
                         "adds true-scale mode='synth' jobs for 1b/3b")
    ap.add_argument("--out", default=str(REPO / "results" /
                                         "family_scores_r3"))
    args = ap.parse_args()

    cfg = ExperimentConfig.from_yaml(args.config).replace(
        epochs=args.epochs, regression_type="multi-quantile",
        quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
        save_plots=False, save_artifacts=False)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    synth_dir = Path(args.synth_data) if args.synth_data else None
    for job in iter_jobs(args.families, Path(args.data_dir), synth_dir):
        if args.only and job["name"] not in args.only \
                and job["name"].split("@")[0] not in args.only:
            # '--only 1b_1' selects the splitsol job AND its '@synth'
            # counterpart; the suffixed form still works for one alone
            continue
        t0 = time.time()
        try:
            metrics, n_train, n_eval, n_ep = run_job(job, cfg, args.seed,
                                                     args.holdout)
        except Exception as e:  # keep scoring the rest (ref error.txt style)
            print(f"[FAILED] {job['name']}: {e}")
            rows.append(dict(name=job["name"], fam=job["fam"],
                             mode=job["mode"], error=str(e)))
            continue
        wall = time.time() - t0
        row = dict(name=job["name"], fam=job["fam"], mode=job["mode"],
                   sol_col=job["sol_col"], n_train=n_train, n_eval=n_eval,
                   epochs_run=n_ep, seconds=round(wall, 1), **metrics)
        rows.append(row)
        print(f"[SCORE] {job['name']:<10} mode={job['mode']:<8} "
              f"RMSE={metrics['rmse']:.4f} MAE={metrics['mae']:.4f} "
              f"CRPS={metrics['crps']:.4f}  ({wall:.0f}s, {n_ep} epochs)")

    df = pd.DataFrame(rows)
    df.to_csv(out_dir / "scores.csv", index=False)
    with open(out_dir / "scores.json", "w") as f:
        json.dump(rows, f, indent=2)
    print(f"\n[OK] wrote {out_dir}/scores.csv")
    if "rmse" in df.columns:
        # group by (fam, mode): synth rows score against a synthetic GRF
        # realization at a different scale — pooling them with the real
        # splitsol/train scores would make the family means reflect neither
        # protocol
        print(df.groupby(["fam", "mode"])[["rmse", "mae", "crps"]]
              .mean().round(4))


if __name__ == "__main__":
    main()
