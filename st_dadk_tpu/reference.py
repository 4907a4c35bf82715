"""Plain single-lane reference of the DA-STDK model and its training loss.

Written from the math, independent of `models/st_interp.py`, the training
loop and the batch engine: float32 `jax.numpy` evaluated under
`jax.default_matmul_precision("highest")`, one lane, no vmap, no packing,
no pregathered minibatches. It reads the architecture from an
`ExperimentConfig` and takes the parameters and basis constants as data in
the engine's nested-dict layout ({"basis": ..., "mlp": {"linear_i", "ln_i",
"out" | "delta"}} and consts' basis centres and bandwidths).

    z(s, t) = head(MLP([phi(s) | psi(t)]))
    phi_j(s) = B(||s - c_j|| / (h_j * a_B))        spatial basis B, support
                                                   calibration a_B
    B = Wendland C4: (1 - r)_+^6 (35 r^2 + 18 r + 3) / 3
        Gaussian:    exp(-r^2 / 2)
        triangular:  (1 - r)_+
    psi_m(t) = exp(-((t - c_m) / h_m)^2 / 2)
    MLP layer: ReLU(LayerNorm(x W + b)) [* keep / (1 - p) with dropout]
    head: x W + b, or the cumulative-delta head
          beta_k = sum_{i <= k} delta_i,  q_k = beta_k0 + x . beta_k,1:
    loss: weighted mean check loss rho_tau(e) = max(tau e, (tau - 1) e),
          e = y - q (mean over quantiles for multi-quantile; squared error
          for 'mean'), plus the training penalties: domain (squared
          violation of [0, 1]^2 by the centres), movement (squared
          displacement from the initial centres) and the first-layer
          sparsity penalties (L1 and/or row-group L2 norms).

Where a reference tolerance is stated (chip_smoke.py, the tests), this module
is the side that is exact to float32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from st_dadk_tpu.config import ExperimentConfig

# divisor of the bandwidth that matches the three bases' effective support
# (reference st_interp.py:56-60)
SUPPORT_CALIBRATION = {"wendland": 1.0, "gaussian": 0.223477,
                       "triangular": 0.654714}

# sqrt'(0) is infinite: a centre that lands exactly on a point would give a
# NaN gradient. Distances below 1e-12 are read as 1e-12 (the value of every
# basis there is its value at r = 0 to float32 precision).
_MIN_SQ_DIST = 1e-24


def _check_supported(cfg: ExperimentConfig) -> None:
    if cfg.k_spatial_pad is not None or cfg.p_covariates:
        raise NotImplementedError("reference: ragged-k padding and "
                                  "covariates are not modelled")
    if cfg.non_crossing_weight > 0 or cfg.non_crossing_lambda > 0:
        raise NotImplementedError("reference: non-crossing penalties are "
                                  "not modelled")


def basis_fn(r: jax.Array, kind: str) -> jax.Array:
    if kind == "wendland":
        return jnp.maximum(1.0 - r, 0.0) ** 6 * (35.0 * r * r + 18.0 * r
                                                   + 3.0) / 3.0
    if kind == "gaussian":
        return jnp.exp(-0.5 * r * r)
    if kind == "triangular":
        return jnp.maximum(1.0 - r, 0.0)
    raise ValueError(f"unknown basis {kind!r}")


def features(cfg: ExperimentConfig, params: Dict[str, Any],
             consts: Dict[str, Any], coords: jax.Array,
             t: jax.Array) -> jax.Array:
    """[phi(s) | psi(t)]: (N, k_spatial + k_temporal)."""
    if cfg.spatial_learnable:
        centers = params["basis"]["centers"]
        bandwidths = jnp.exp(params["basis"]["log_bandwidths"])
    else:
        centers = consts["spatial_centers_init"]
        bandwidths = consts["spatial_bandwidths_init"]
    diff = coords[:, None, :] - centers[None, :, :]              # (N, k, 2)
    dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1),
                                _MIN_SQ_DIST))
    scale = bandwidths * SUPPORT_CALIBRATION[cfg.spatial_basis_function]
    phi = basis_fn(dist / scale[None, :], cfg.spatial_basis_function)
    u = (t.reshape(-1, 1) - consts["temporal_centers"][None, :]) \
        / consts["temporal_bandwidths"][None, :]
    psi = jnp.exp(-0.5 * u * u)
    return jnp.concatenate([phi, psi], axis=1)


def forward(cfg: ExperimentConfig, params: Dict[str, Any],
            consts: Dict[str, Any], coords: jax.Array, t: jax.Array,
            keep: Optional[Sequence[jax.Array]] = None) -> jax.Array:
    """Quantile (or mean) predictions (N, Q). `keep` holds one boolean
    dropout keep-mask (N, width) per hidden layer; None means eval mode."""
    _check_supported(cfg)
    with jax.default_matmul_precision("highest"):
        mlp = params["mlp"]
        x = features(cfg, params, consts, coords, t)
        for i in range(len(cfg.hidden_dims)):
            x = x @ mlp[f"linear_{i}"]["w"] + mlp[f"linear_{i}"]["b"]
            if cfg.layernorm:
                mu = jnp.mean(x, axis=1, keepdims=True)
                var = jnp.mean((x - mu) ** 2, axis=1, keepdims=True)
                x = (x - mu) / jnp.sqrt(var + 1e-5)
                x = x * mlp[f"ln_{i}"]["scale"] + mlp[f"ln_{i}"]["bias"]
            x = jnp.maximum(x, 0.0)
            if keep is not None and cfg.dropout > 0:
                x = jnp.where(keep[i], x / (1.0 - cfg.dropout), 0.0)
        if "delta" in mlp:
            beta = jnp.cumsum(mlp["delta"], axis=0)               # (Q, 1 + d)
            return beta[:, 0][None, :] + x @ beta[:, 1:].T
        return x @ mlp["out"]["w"] + mlp["out"]["b"]


def _sparsity(w: jax.Array, cfg: ExperimentConfig) -> jax.Array:
    """First-layer sparsity of one input block; rows are basis functions."""
    kind = cfg.sparsity_penalty_type
    l1 = jnp.sum(jnp.sign(w) * w)            # |w|, subgradient 0 at w = 0
    sq = jnp.sum(w * w, axis=1)
    # row norms, with zero rows contributing 0 and a zero gradient
    group = jnp.sum(jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1.0)),
                              0.0))
    if kind == "element":
        return cfg.sparsity_lambda_l1 * l1
    if kind == "group":
        return cfg.sparsity_lambda_group * group
    if kind == "sparse_group":
        return cfg.sparsity_lambda_group * group + cfg.sparsity_lambda_l1 * l1
    raise ValueError(f"unknown sparsity penalty {kind!r}")


def loss(cfg: ExperimentConfig, params: Dict[str, Any],
         consts: Dict[str, Any], coords: jax.Array, t: jax.Array,
         y: jax.Array, w: jax.Array,
         keep: Optional[Sequence[jax.Array]] = None) -> jax.Array:
    """The training objective on one minibatch: weighted data loss plus the
    penalties the config turns on. y: (N, 1) targets, w: (N,) 0/1 weights."""
    q = forward(cfg, params, consts, coords, t, keep)
    with jax.default_matmul_precision("highest"):
        e = y - q                                                  # (N, Q)
        if cfg.regression_type == "mean":
            per_point = jnp.mean(e * e, axis=1)
        else:
            if cfg.regression_type == "multi-quantile":
                tau = jnp.asarray(cfg.quantile_levels, jnp.float32)[None, :]
            else:
                tau = float(cfg.current_quantile
                            if cfg.current_quantile is not None
                            else cfg.quantile_levels[0])
            per_point = jnp.mean(jnp.maximum(tau * e, (tau - 1.0) * e),
                                 axis=1)
        total = jnp.sum(w * per_point) / jnp.maximum(jnp.sum(w), 1e-12)

        if cfg.spatial_learnable:
            c = params["basis"]["centers"]
            if cfg.domain_penalty_weight > 0:
                out = jnp.maximum(-c, 0.0) + jnp.maximum(c - 1.0, 0.0)
                total = total + cfg.domain_penalty_weight * jnp.sum(out * out)
            if cfg.movement_penalty_weight > 0:
                d = c - consts["spatial_centers_init"]
                total = total + cfg.movement_penalty_weight * jnp.sum(d * d)
        if cfg.sparsity_penalty_type != "none":
            w0 = params["mlp"]["linear_0"]["w"]
            k_s = int(sum(cfg.k_spatial_centers))
            if cfg.sparsity_apply_to_spatial:
                total = total + _sparsity(w0[:k_s], cfg)
            if cfg.sparsity_apply_to_temporal:
                total = total + _sparsity(w0[k_s:], cfg)
        return total


def loss_and_grad(cfg: ExperimentConfig, params: Dict[str, Any],
                  consts: Dict[str, Any], coords: jax.Array, t: jax.Array,
                  y: jax.Array, w: jax.Array,
                  keep: Optional[Sequence[jax.Array]] = None):
    """(loss, d loss / d params), differentiated under "highest"."""
    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(
            lambda p: loss(cfg, p, consts, coords, t, y, w, keep))(params)
