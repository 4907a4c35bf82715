"""Losses, penalties, and probabilistic scores.

Parity targets in the reference:
  - check (quantile) loss: mean(max((tau-1) e, tau e)), e = y - yhat
    (scripts/train_st_interp.py:37-50)
  - prediction-level non-crossing penalty: sum_k ReLU(q_k - q_{k+1})^p,
    p in {1,2}, batch mean/sum (train_st_interp.py:53-85)
  - delta-level penalty P_nc(delta) = sum_{k=2..Q} [d_k0 - max(d_k0,
    sum_j max(0, -d_kj))]  (Eq. 3.10; train_st_interp.py:88-150). Always <= 0;
    the reference's sign-convention caveat (docstring :100-110) is preserved
    here verbatim in behavior: the penalty is ADDED as lambda * P_nc(delta).
  - CRPS (Eq. 4.6): 2 * sum_k w_k rho_{tau_k}(y - Q_{tau_k}) with uniform
    weights by default and normalization of custom weights
    (train_st_interp.py:169-248).

All on-device losses accept an optional `weights` vector so padded (static
shape) batches reproduce the reference's ragged-batch means exactly:
weighted_mean(x, w) == mean(x[w > 0]) when w is 0/1.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _weighted_mean(x: jax.Array, weights: Optional[jax.Array]) -> jax.Array:
    if weights is None:
        return jnp.mean(x)
    w = weights.reshape(x.shape[0], *([1] * (x.ndim - 1)))
    denom = jnp.maximum(jnp.sum(w) * (x.size / x.shape[0]), 1e-12)
    return jnp.sum(x * w) / denom


def quantile_loss(y_pred: jax.Array, y_true: jax.Array, quantile: float,
                  weights: Optional[jax.Array] = None) -> jax.Array:
    """Check loss rho_tau, mean over the (optionally weighted) batch."""
    errors = y_true - y_pred
    per_elem = jnp.maximum((quantile - 1.0) * errors, quantile * errors)
    return _weighted_mean(per_elem, weights)


def multi_quantile_loss(y_pred: jax.Array, y_true: jax.Array,
                        quantile_levels: jax.Array,
                        weights: Optional[jax.Array] = None) -> jax.Array:
    """Mean over quantiles of the per-quantile check loss.

    y_pred: (B, Q); y_true: (B, 1); quantile_levels: (Q,).
    Matches the reference's loop-and-stack mean (train_st_interp.py:624-631)
    as one vectorized reduction.
    """
    errors = y_true - y_pred                                   # (B, Q)
    q = quantile_levels[None, :]
    per_elem = jnp.maximum((q - 1.0) * errors, q * errors)     # (B, Q)
    if weights is None:
        return jnp.mean(per_elem)
    w = weights[:, None]
    denom = jnp.maximum(jnp.sum(w), 1e-12)
    # mean over quantiles of weighted batch means == weighted mean of
    # per-sample quantile means
    return jnp.sum(per_elem * w) / (denom * per_elem.shape[1])


def mse_loss(y_pred: jax.Array, y_true: jax.Array,
             weights: Optional[jax.Array] = None) -> jax.Array:
    return _weighted_mean((y_pred - y_true) ** 2, weights)


def non_crossing_penalty(y_pred_multi_q: jax.Array, reduction: str = "mean",
                         power: int = 1,
                         weights: Optional[jax.Array] = None) -> jax.Array:
    """Prediction-level hinge penalty on quantile crossings (ref :53-85)."""
    if y_pred_multi_q.ndim != 2 or y_pred_multi_q.shape[1] < 2:
        return jnp.asarray(0.0, dtype=jnp.float32)
    diffs = y_pred_multi_q[:, :-1] - y_pred_multi_q[:, 1:]
    violations = jax.nn.relu(diffs)
    if power == 2:
        violations = violations ** 2
    elif power != 1:
        raise ValueError(f"Unsupported power={power}; use 1 or 2.")
    per_sample = violations.sum(axis=1)
    if reduction == "mean":
        return _weighted_mean(per_sample, weights)
    if reduction == "sum":
        if weights is not None:
            per_sample = per_sample * weights
        return per_sample.sum()
    raise ValueError(f"Unsupported reduction='{reduction}'; use 'mean' or 'sum'.")


def p_nc_delta_penalty(delta: Optional[jax.Array]) -> jax.Array:
    """P_nc(delta) on the stacked delta matrix (Q, d+1) (ref Eq. 3.10, :88-150).

    J(delta_k) = delta_k0 - max(delta_k0, sum_j max(0, -delta_kj)) for
    k = 2..Q (row indices 1..Q-1); P_nc = sum_k J(delta_k) <= 0.
    Note the reference's open TODO about the sign convention is intentionally
    reproduced, not "fixed": the penalty is added to the loss as-is.
    """
    if delta is None or delta.shape[0] < 2:
        return jnp.asarray(0.0, dtype=jnp.float32)
    d = delta[1:]                                   # (Q-1, d+1)
    d0 = d[:, 0]
    sum_negative = jax.nn.relu(-d[:, 1:]).sum(axis=1)
    j = d0 - jnp.maximum(d0, sum_negative)
    return j.sum()


# ---------------------------------------------------------------------------
# Offline (numpy) scores — these run on eval results, not in the hot loop.
# ---------------------------------------------------------------------------

def check_loss_np(y_pred: np.ndarray, y_true: np.ndarray, quantile: float) -> float:
    errors = np.asarray(y_true, dtype=np.float64) - np.asarray(y_pred, dtype=np.float64)
    return float(np.mean(np.maximum((quantile - 1.0) * errors, quantile * errors)))


def compute_crps(predictions_dict: Dict[float, np.ndarray], y_true: np.ndarray,
                 weights: Optional[Sequence[float]] = None) -> float:
    """CRPS via quantile quadrature (Eq. 4.6): 2 * sum_k w_k rho_{tau_k}.

    predictions_dict maps quantile level -> predictions (N,).
    Uniform weights w_k = 1/K by default; custom weights are normalized to
    sum to 1 (ref train_st_interp.py:169-223). NOTE reference parity:
    weights pair with the SORTED quantile order while the keys are sorted
    independently (ref :190/:215-219) — pass weights in ascending-tau order.
    """
    quantiles = sorted(predictions_dict.keys())
    K = len(quantiles)
    if K == 0:
        raise ValueError("predictions_dict cannot be empty")
    if K == 1:
        q = quantiles[0]
        return 2.0 * check_loss_np(predictions_dict[q], y_true, q)
    if weights is None:
        w = np.full(K, 1.0 / K)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if len(w) != K:
            raise ValueError(
                f"weights length ({len(w)}) must match number of quantiles ({K})")
        w = w / w.sum()
    crps_sum = 0.0
    for i, q in enumerate(quantiles):
        crps_sum += w[i] * check_loss_np(predictions_dict[q], y_true, q)
    return 2.0 * float(crps_sum)


def compute_crps_multi_quantile(preds: np.ndarray, y_true: np.ndarray,
                                quantile_levels: Sequence[float],
                                weights: Optional[Sequence[float]] = None) -> float:
    """CRPS from an (N, Q) prediction matrix (ref train_st_interp.py:226-248)."""
    y = np.asarray(y_true)
    if y.ndim > 1:
        y = y.reshape(-1)
    predictions_dict = {q: preds[:, i] for i, q in enumerate(quantile_levels)}
    return compute_crps(predictions_dict, y, weights=weights)
