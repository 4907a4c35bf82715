"""KAUST competition CSV ingest.

Behavioral parity with stnf/dataio/kaust_loader.py, re-implemented with
vectorized numpy (the reference fills the dense matrix with a Python
`iterrows` loop, kaust_loader.py:59-63, which costs seconds per 100k-row file
and is re-paid once per experiment repeat; here ingest is one site
factorization + one fancy assignment).

Contracts preserved:
  - sites are unique (x, y) pairs in order of first appearance
    (kaust_loader.py:40-51)
  - t is 1-based in the files; the dense matrix is 0-based (T, S)
    (kaust_loader.py:54-63)
  - optional z-score normalization with stats in metadata
    (kaust_loader.py:66-74)

Extensions beyond the reference (documented divergence): spatial-only files
(1a/3a: columns x,y,z with no t) load as T=1, and an extra leading id column
is tolerated — the reference loader cannot read those families at all.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def read_csv_columns(path: str | Path) -> Dict[str, np.ndarray]:
    """Numeric CSV with a header row -> {column name: float64 column}.
    Header names are stripped of spaces and quotes; empty fields read NaN."""
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline()
    names = [c.strip().strip('"') for c in header.strip().split(",")]
    data = np.genfromtxt(path, delimiter=",", skip_header=1,
                         dtype=np.float64, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, len(names)))
    return {n: data[:, i] for i, n in enumerate(names)}


def _site_index(x: np.ndarray, y: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Return (site_codes per row, coords (S,2) float32, site_to_idx dict);
    sites are numbered in order of first appearance."""
    xy = np.column_stack([x, y]).astype(np.float64)
    uniq, first, inverse = np.unique(xy, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")   # first-appearance order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    codes = rank[np.asarray(inverse).ravel()]
    uniques = uniq[order]
    site_to_idx = {(float(a), float(b)): i for i, (a, b) in enumerate(uniques)}
    return codes, uniques.astype(np.float32), site_to_idx


def load_kaust_csv_single(
    data_path: str | Path,
    normalize: bool = True,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Load one CSV with columns (x, y, t, z) [or (x, y, z) for spatial-only].

    Returns:
        z_data: (T, S) float32 dense matrix (NaN where unobserved)
        coords: (S, 2) float32, already in [0,1]^2
        metadata: dict with normalization stats etc.

    Uses the native C++ one-pass ingest when built (native/ingest.cpp);
    otherwise the vectorized numpy path. Both produce identical outputs.
    """
    from st_dadk_tpu.dataio.native import load_csv_native

    native = load_csv_native(data_path)
    if native is not None:
        z_data, coords64, n_rows = native
        T, S = z_data.shape
        # site_to_idx keys must be the CSV's exact float64 values (what
        # predictions_to_csv looks up); coords downcast only for the model
        site_to_idx = {(float(x), float(y)): i
                       for i, (x, y) in enumerate(coords64)}
        coords = coords64.astype(np.float32)
        if verbose:
            print(f"[INFO] Loaded data: {n_rows} rows (native)")
            print(f"[INFO] Total sites: {S}")
            print(f"[INFO] Time range: 1 ~ {T}")
    else:
        cols = read_csv_columns(data_path)
        n_rows = len(cols["x"])
        if verbose:
            print(f"[INFO] Loaded data: {n_rows} rows")

        codes, coords, site_to_idx = _site_index(cols["x"], cols["y"])
        S = coords.shape[0]
        if verbose:
            print(f"[INFO] Total sites: {S}")

        if "t" in cols:
            t_idx = cols["t"].astype(np.int64) - 1
            T = int(t_idx.max()) + 1 if n_rows else 1
            if verbose:
                print(f"[INFO] Time range: 1 ~ {T}")
        else:
            # spatial-only dataset (1a/3a families) — single time slice
            T = 1
            t_idx = np.zeros(n_rows, dtype=np.int64)

        z_data = np.full((T, S), np.nan, dtype=np.float32)
        if "z" in cols:
            z_data[t_idx, codes] = cols["z"].astype(np.float32)

    # z_mean/z_std are always present (0/1 when not normalizing) — same
    # contract as load_kaust_csv; consumers like predictions_to_csv rely on it
    metadata: Dict = {"S": S, "T": T, "site_to_idx": site_to_idx,
                      "z_mean": 0.0, "z_std": 1.0}
    z_flat = z_data[~np.isnan(z_data)]
    if normalize and z_flat.size:
        # z-less files (the *_test.csv layout tolerated above) keep the
        # 0/1 identity stats: an empty slice's mean/std would poison
        # metadata with NaN and make every later denormalization NaN
        z_mean = float(z_flat.mean())
        z_std = float(z_flat.std()) + 1e-8   # constant field: no div-by-0
        z_data = (z_data - z_mean) / z_std
        metadata["z_mean"] = z_mean
        metadata["z_std"] = z_std
        if verbose:
            print(f"[INFO] Normalized z: mean={z_mean:.4f}, std={z_std:.4f}")

    return z_data, coords, metadata


def load_kaust_csv(
    train_path: str | Path,
    test_path: str | Path,
    normalize: bool = True,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict, Dict]:
    """Load a train/test CSV pair with a combined site index
    (ref kaust_loader.py:79-175).

    Returns (z_train (T_tr,S), z_test (T_te,S; NaN), coords, site_to_idx, metadata).
    """
    tr = read_csv_columns(train_path)
    te = read_csv_columns(test_path)
    n_tr = len(tr["x"])
    if verbose:
        print(f"[INFO] Loaded train: {n_tr} rows")
        print(f"[INFO] Loaded test: {len(te['x'])} rows")

    codes_all, coords, site_to_idx = _site_index(
        np.concatenate([tr["x"], te["x"]]), np.concatenate([tr["y"], te["y"]]))
    S = coords.shape[0]
    codes_train = codes_all[:n_tr]
    if verbose:
        print(f"[INFO] Total sites: {S}")

    has_t = "t" in tr
    if has_t:
        T_tr = int(tr["t"].max())
        T_te_start = int(te["t"].min())
        T_te_end = int(te["t"].max())
        t_idx_train = tr["t"].astype(np.int64) - 1
        if verbose:
            print(f"[INFO] Train time range: 1 ~ {T_tr}")
            print(f"[INFO] Test time range: {T_te_start} ~ {T_te_end}")
    else:
        T_tr, T_te_start, T_te_end = 1, 1, 1
        t_idx_train = np.zeros(n_tr, dtype=np.int64)

    z_train = np.full((T_tr, S), np.nan, dtype=np.float32)
    if "z" in tr:
        z_train[t_idx_train, codes_train] = tr["z"].astype(np.float32)

    T_te = T_te_end - T_te_start + 1
    z_test = np.full((T_te, S), np.nan, dtype=np.float32)

    metadata: Dict = {}
    if normalize:
        valid = z_train[~np.isnan(z_train)]
        z_mean = float(valid.mean())
        z_std = float(valid.std() + 1e-8)
        z_train = (z_train - z_mean) / z_std
        metadata["z_mean"] = z_mean
        metadata["z_std"] = z_std
        if verbose:
            print(f"[INFO] Normalized: mean={z_mean:.4f}, std={z_std:.4f}")
    else:
        metadata["z_mean"], metadata["z_std"] = 0.0, 1.0

    metadata.update({"S": S, "T_tr": T_tr, "T_te": T_te,
                     "T_te_start": T_te_start, "coords": coords,
                     "site_to_idx": site_to_idx})
    return z_train, z_test, coords, site_to_idx, metadata


def sample_observed_sites(
    coords: np.ndarray,
    obs_fraction: float,
    sampling_method: str = "uniform",
    bias_sigma: float = 0.15,
    bias_temp: float = 1.0,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Uniform or origin-biased site subset (ref kaust_loader.py:178-234)."""
    if seed is not None:
        np.random.seed(seed)
    S = len(coords)
    n_obs = max(1, int(S * obs_fraction))
    if sampling_method == "uniform":
        obs_indices = np.random.choice(S, size=n_obs, replace=False)
    elif sampling_method == "biased":
        distances = np.sqrt(coords[:, 0] ** 2 + coords[:, 1] ** 2)
        weights = np.exp(-(distances ** 2) / (2 * bias_sigma ** 2))
        weights = weights ** (1.0 / bias_temp)
        probs = weights / weights.sum()
        obs_indices = np.random.choice(S, size=n_obs, replace=False, p=probs)
    else:
        raise ValueError(f"Unknown sampling method: {sampling_method}")
    return np.sort(obs_indices)


def predictions_to_csv(
    y_pred: np.ndarray,
    test_csv_path: str | Path,
    output_path: str | Path,
    site_to_idx: Dict,
    z_mean: float,
    z_std: float,
    denormalize: bool = True,
) -> None:
    """Competition submission writer (ref kaust_loader.py:518-565),
    vectorized over the test rows."""
    te = read_csv_columns(test_csv_path)
    if denormalize:
        y_pred = y_pred * z_std + z_mean

    n = len(te["x"])
    t = te["t"].astype(np.int64) if "t" in te else np.ones(n, np.int64)
    t_rel = t - t.min() if n else t
    site_idx = np.array([site_to_idx[(float(x), float(y))]
                         for x, y in zip(te["x"], te["y"])], dtype=np.int64)
    z_hat = np.full(n, np.nan, dtype=np.float64)
    in_range = t_rel < len(y_pred)
    z_hat[in_range] = y_pred[t_rel[in_range], site_idx[in_range]]
    with open(output_path, "w", encoding="utf-8") as f:
        f.write("z\n")
        f.writelines(f"{float(v)!r}\n" if np.isfinite(v) else "\n"
                     for v in z_hat)
    print(f"[INFO] Saved predictions to {output_path}")
