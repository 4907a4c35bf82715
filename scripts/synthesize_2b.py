#!/usr/bin/env python
"""Reconstruct 2b train data for the Table 4.4 protocol.

The reference snapshot ships only `data/2b/2b_*_test.csv` (x, y, t with NO z
— the competition withheld them), but `run_table_4_4.py` trains on
`data/2b/2b_8.csv` (SURVEY.md section 6 caveat). With no network egress the
official release cannot be fetched, so this script synthesizes a statistical
equivalent:

  1. estimate the spatio-temporal covariance of the REAL 2a_8 field (same
     ExaGeoStat generator family, same competition): lag-1 temporal
     autocorrelation across sites + a Matern spatial correlation fitted to
     binned empirical same-time correlations (nugget from the short-range
     intercept);
  2. generate a separable Gaussian random field with those parameters at the
     EXACT 2b site coordinates (the 10,000 sites of 2b_<i>_test.csv), for
     t = 1..T — Cholesky-colored innovations driven through an AR(1).

Output: <out_dir>/2b_<i>.csv with columns x,y,t,z (the full-field layout of
2a_8.csv), plus fit_params.json recording the estimated covariance. This is
a documented SYNTHETIC stand-in — results on it test the Table 4.4 protocol
at 2b's size/layout, not the withheld official field.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.dataio.kaust import read_csv_columns  # noqa: E402
from st_dadk_tpu.dataio.synth import synthesize, write_xytz_csv  # noqa: E402
from st_dadk_tpu.utils.platform import apply_platform_env  # noqa: E402
apply_platform_env()


def fit_2a_covariance(path_2a: Path, n_bins: int = 24, max_h: float = 0.5):
    """Estimate (phi_t, matern params (sigma2, range, nu fixed 1), nugget)
    from the complete 2a field."""
    from st_dadk_tpu.dataio.kaust import load_kaust_csv_single
    z, coords, meta = load_kaust_csv_single(path_2a, normalize=False,
                                            verbose=False)
    z = np.asarray(z, np.float64)                      # (T, S)
    mu, sd = z.mean(), z.std()
    zn = (z - mu) / sd

    # temporal lag-1 autocorrelation, averaged across sites
    z0, z1 = zn[:-1], zn[1:]
    phi = float(np.mean(np.sum(z0 * z1, 0)
                        / np.sqrt(np.sum(z0 * z0, 0) * np.sum(z1 * z1, 0))))

    # spatial: empirical same-time correlation binned by distance
    rng = np.random.default_rng(0)
    S = coords.shape[0]
    ii = rng.integers(0, S, 200_000)
    jj = rng.integers(0, S, 200_000)
    keep = ii != jj
    ii, jj = ii[keep], jj[keep]
    h = np.linalg.norm(coords[ii] - coords[jj], axis=1)
    prod = np.mean(zn[:, ii] * zn[:, jj], axis=0)      # E[z_i z_j] per pair
    from st_dadk_tpu.utils.covariance import fit_matern1
    s2, a, nugget = fit_matern1(h, prod, n_bins=n_bins, max_h=max_h)
    return dict(mean=float(mu), std=float(sd), phi_t=phi,
                sigma2=s2, range_=a, nu=1.0, nugget=nugget)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--indices", type=int, nargs="+", default=[8])
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--out_dir", type=str, default=str(REPO / "data" / "2b"))
    ap.add_argument("--fit_from", type=str,
                    default=str(REPO / "data" / "2a" / "2a_8.csv"))
    ap.add_argument("--sites_from", type=str,
                    default=str(REPO / "data" / "2b"))
    args = ap.parse_args()

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    print(f"[synth2b] fitting covariance from {args.fit_from}")
    params = fit_2a_covariance(Path(args.fit_from))
    print(f"[synth2b] fitted: {params}")
    with open(out_dir / "fit_params.json", "w") as f:
        json.dump(params, f, indent=2)

    for i in args.indices:
        test_csv = Path(args.sites_from) / f"2b_{i}_test.csv"
        cols = read_csv_columns(test_csv)
        first = cols["t"] == cols["t"].min()
        sites = np.column_stack([cols["x"][first], cols["y"][first]])
        print(f"[synth2b] 2b_{i}: {len(sites)} sites x T={args.T}")
        z = synthesize(sites, args.T, params, seed=1000 + i)
        out = write_xytz_csv(out_dir / f"2b_{i}.csv", sites, z)
        print(f"[synth2b] wrote {out} ({z.size} rows)")


if __name__ == "__main__":
    main()
