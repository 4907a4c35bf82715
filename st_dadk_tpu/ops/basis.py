"""Radial basis functions and basis-matrix construction (pure jnp).

Math parity targets (reference, PyTorch):
  - Wendland C4:  phi(r) = (1-r)^6_+ (35 r^2 + 18 r + 3) / 3      (stnf/models/st_interp.py:462-471)
  - Gaussian:     phi(r) = exp(-r^2 / 2)                          (st_interp.py:473-481)
  - Triangular:   phi(r) = (1-r)_+                                (st_interp.py:483-491)
  - Support calibration factors {wendland 1.0, gaussian 0.223477,
    triangular 0.654714} divide the bandwidth so all three have matched
    effective support (st_interp.py:56-60, applied at :447-448).
  - Spatial embed: r = ||s - c|| / (bandwidth * calibration), phi(r)
    (st_interp.py:433-460). Temporal embed: Gaussian RBF of
    (t - c)/bandwidth on 1-D multi-resolution grids (st_interp.py:583-596).
  - Uniform grid init: sqrt(k) x sqrt(k) grids over [0,1]^2 incl. boundaries,
    bandwidth = 2.5 x spacing (st_interp.py:152-185); temporal grids likewise
    on [0,1] (st_interp.py:557-581).

Plain jnp: XLA fuses the subtract / sqrt / polynomial chain of the spatial
embed into one elementwise loop ahead of the first-layer matrix product.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

CALIBRATION_FACTORS = {
    "wendland": 1.000000,
    "gaussian": 0.223477,
    "triangular": 0.654714,
}

BASIS_IDS = {"wendland": 0, "gaussian": 1, "triangular": 2}


def wendland_c4(r: jax.Array) -> jax.Array:
    """Wendland C4 compactly supported RBF; support [0, 1].

    Matches the reference exactly, including the clamp-at-1 formulation
    (the (1-r)^6 factor is 0 at r=1 so clamping gives the same value as
    masking, with identical gradients on r < 1).
    """
    r = jnp.minimum(r, 1.0)
    one_minus = 1.0 - r
    p6 = one_minus ** 6
    return p6 * (35.0 * r * r + 18.0 * r + 3.0) / 3.0


def gaussian_rbf(r: jax.Array) -> jax.Array:
    return jnp.exp(-0.5 * r * r)


def triangular_basis(r: jax.Array) -> jax.Array:
    return jnp.maximum(1.0 - r, 0.0)


_BASIS_FNS = (wendland_c4, gaussian_rbf, triangular_basis)


def apply_basis(r: jax.Array, basis_function: str) -> jax.Array:
    if basis_function not in BASIS_IDS:
        raise ValueError(f"Unknown basis function: {basis_function}. "
                         f"Choose from {list(BASIS_IDS)}")
    return _BASIS_FNS[BASIS_IDS[basis_function]](r)


def spatial_basis_embed(
    coords: jax.Array,            # (N, 2) in [0,1]^2
    centers: jax.Array,           # (k, 2)
    bandwidths: jax.Array,        # (k,)
    basis_function: str = "wendland",
) -> jax.Array:
    """phi(s): (N, k) basis matrix.

    Distances are computed elementwise (dx^2 + dy^2) rather than via a
    cdist-style matmul: with only 2 input dims a matrix product buys nothing
    and the elementwise form fuses with the basis polynomial.
    """
    calibration = CALIBRATION_FACTORS[basis_function]
    dx = coords[:, 0:1] - centers[None, :, 0]    # (N, k)
    dy = coords[:, 1:2] - centers[None, :, 1]    # (N, k)
    d2 = dx * dx + dy * dy
    # max-guard keeps sqrt's gradient finite when a (learnable) center lands
    # exactly on a data point — d sqrt/d d2 is masked to 0 at d2 <= eps, so
    # the coincident pair contributes zero gradient (torch.cdist's backward
    # has the same guard; without it centers NaN on the first step).
    dist = jnp.sqrt(jnp.maximum(d2, 1e-24))
    r = dist / (bandwidths[None, :] * calibration)
    return apply_basis(r, basis_function)


def temporal_basis_embed(
    t: jax.Array,                 # (N, 1) or (N,) normalized time
    centers: jax.Array,           # (k_t,)
    bandwidths: jax.Array,        # (k_t,)
) -> jax.Array:
    """psi(t): (N, k_t) Gaussian RBF embedding (always Gaussian, ref :583-596)."""
    t = t.reshape(-1, 1)
    diff = (t - centers[None, :]) / bandwidths[None, :]
    return jnp.exp(-0.5 * diff * diff)


# ---------------------------------------------------------------------------
# Fixed-grid initializers (numpy at init time; run once per fit)
# ---------------------------------------------------------------------------

def uniform_grid_centers(n_centers: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-resolution regular grids over [0,1]^2; bandwidth = 2.5 x spacing.

    Each k in n_centers must be a perfect square (ref st_interp.py:157-159).
    Returns (centers (sum_k, 2), bandwidths (sum_k,)) as float32.
    """
    centers_list: List[np.ndarray] = []
    bw_list: List[np.ndarray] = []
    for k in n_centers:
        side = int(math.isqrt(int(k)))
        if side * side != k:
            raise ValueError(f"n_centers must be perfect squares, got {k}")
        ax = np.linspace(0.0, 1.0, side, dtype=np.float64)
        xx, yy = np.meshgrid(ax, ax, indexing="ij")
        centers_list.append(
            np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32))
        spacing = 1.0 / (side - 1) if side > 1 else 1.0
        bw_list.append(np.full((k,), 2.5 * spacing, dtype=np.float32))
    return np.concatenate(centers_list, axis=0), np.concatenate(bw_list, axis=0)


def temporal_grid_centers(n_centers: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-resolution regular 1-D grids over [0,1]; bandwidth = 2.5 x spacing."""
    centers_list: List[np.ndarray] = []
    bw_list: List[np.ndarray] = []
    for n in n_centers:
        centers_list.append(np.linspace(0.0, 1.0, int(n)).astype(np.float32))
        spacing = 1.0 / (n - 1) if n > 1 else 1.0
        bw_list.append(np.full((int(n),), 2.5 * spacing, dtype=np.float32))
    return np.concatenate(centers_list), np.concatenate(bw_list)


def uniform_bandwidth_for(k: int) -> float:
    """Reference uniform-grid bandwidth for a resolution of k centers
    (used as a clipping floor by the GMM init, ref st_interp.py:216-221)."""
    side = int(math.isqrt(int(k)))
    spacing = 1.0 / (side - 1) if side > 1 else 1.0
    return 2.5 * spacing
