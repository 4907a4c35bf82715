"""In-repository spatio-temporal fields: a separable Gaussian random field.

`data/2b/fit_params.json` holds the covariance fitted to the real 2a_8 field
of the KAUST competition (lag-1 temporal autocorrelation across sites, a
Matern nu=1 spatial correlation with a nugget; see scripts/synthesize_2b.py).
`synthesize` draws a field with that covariance — AR(1) in time,
Cholesky-coloured Matern innovations in space — so every workload can train
on data generated from a seed instead of a dataset outside the repository.
numpy and scipy only.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
FIT_PARAMS_2B = REPO / "data" / "2b" / "fit_params.json"

# the 2a_8-shaped field the bench workload trains on (git-ignored; made on
# first use by ensure_2a8_field)
FIELD_2A8 = "data/synth/2a_8.csv"
FIELD_2A8_SHAPE = (100, 1000)          # (T, S) of the real 2a_8 file
FIELD_2A8_SEED = 8


def load_fit_params(path: Path = FIT_PARAMS_2B) -> Dict[str, float]:
    with open(path) as f:
        return json.load(f)


def uniform_sites(S: int, seed: int) -> np.ndarray:
    """(S, 2) float64 sites uniform in [0, 1]^2, rounded to the 6 decimals
    the CSV keeps (so the file's coordinates are exactly these)."""
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(size=(S, 2)), 6)


def synthesize(sites: np.ndarray, T: int, params: Dict[str, float],
               seed: int) -> np.ndarray:
    """Separable GRF: AR(1)-in-time Cholesky-coloured spatial innovations.
    Returns (T, S) float32 in the ORIGINAL scale (params' mean and std)."""
    from scipy.special import kv

    S = len(sites)
    d = np.linalg.norm(sites[:, None, :] - sites[None, :, :], axis=-1)
    hh = np.maximum(d, 1e-12) * np.sqrt(2.0) / params["range_"]
    C = params["sigma2"] * hh * kv(1, hh)
    np.fill_diagonal(C, params["sigma2"] + params["nugget"])
    C += 1e-6 * np.eye(S)
    L = np.linalg.cholesky(C)

    rng = np.random.default_rng(seed)
    phi = params["phi_t"]
    z = np.empty((T, S), np.float64)
    z[0] = L @ rng.standard_normal(S)
    scale = np.sqrt(1.0 - phi * phi)
    for t in range(1, T):
        z[t] = phi * z[t - 1] + scale * (L @ rng.standard_normal(S))
    out = params["mean"] + params["std"] * z
    return out.astype(np.float32)


def write_xytz_csv(path: Path, sites: np.ndarray, z: np.ndarray) -> Path:
    """Write a (T, S) field as the KAUST full-field layout x,y,t,z
    (t 1-based, sites repeated per time step). The file appears atomically,
    so concurrent writers of the same field never expose a partial file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    T, S = z.shape
    rows = np.column_stack([
        np.tile(sites[:, 0], T), np.tile(sites[:, 1], T),
        np.repeat(np.arange(1, T + 1), S), z.ravel()])
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    np.savetxt(tmp, rows, fmt=["%.6f", "%.6f", "%d", "%.6f"], delimiter=",",
               header="x,y,t,z", comments="")
    tmp.replace(path)
    return path


def ensure_field(path: Path, S: int, T: int, seed: int,
                 params: Optional[Dict[str, float]] = None) -> Path:
    """Generate the field at `path` unless it is already there. The file is
    a pure function of (S, T, seed, params)."""
    path = Path(path)
    if not path.exists():
        params = params or load_fit_params()
        sites = uniform_sites(S, seed)
        write_xytz_csv(path, sites, synthesize(sites, T, params, seed))
    return path


def ensure_2a8_field(root: Path = REPO) -> Path:
    """The 2a_8-shaped field (T=100, S=1000) of the bench workload."""
    T, S = FIELD_2A8_SHAPE
    return ensure_field(Path(root) / FIELD_2A8, S, T, FIELD_2A8_SEED)
