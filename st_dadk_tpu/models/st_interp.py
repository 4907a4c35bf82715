"""Spatio-temporal interpolation model as pure functions over a param pytree.

Architecture (parity with stnf/models/st_interp.py:599-882):
    input  [X covariates (p) | phi(s) spatial basis | psi(t) temporal basis]
    -> MLP: per hidden layer Linear -> LayerNorm -> ReLU -> Dropout
    -> head: direct Linear(out_dim) OR delta-reparameterized multi-quantile
       head: beta_k = cumsum_k(delta), yhat_k = beta_k0 + h . beta_k(1:)
       (ref st_interp.py:849-877 — the reference's per-quantile Python loop is
       one cumsum + one matmul here).

Params are a plain dict pytree so experiments can be vmapped over a leading
axis and optimizers can mask parameter groups by path. Static architecture
facts live in the hashable ModelSpec (a jit static argument).

Initialization distributions match torch defaults: Linear weights/biases
~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); LayerNorm gamma=1, beta=0; delta
~ N(0, 0.01) (ref st_interp.py:679-686).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.ops.basis import (
    CALIBRATION_FACTORS,
    apply_basis,
    spatial_basis_embed,
    temporal_basis_embed,
    temporal_grid_centers,
    uniform_grid_centers,
)

Params = Dict[str, Any]
Consts = Dict[str, Any]


@dataclass(frozen=True)
class ModelSpec:
    p: int = 0
    k_spatial_centers: Tuple[int, ...] = (25, 81, 121)
    k_temporal_centers: Tuple[int, ...] = (10, 15, 45)
    hidden_dims: Tuple[int, ...] = (256, 256, 128)
    dropout: float = 0.1
    layernorm: bool = True
    spatial_basis_function: str = "wendland"
    spatial_learnable: bool = False
    output_dim: int = 1
    use_delta_reparameterization: bool = False
    # activation dtype for the training trunk: 'bf16' materializes the MLP
    # activations (and their cotangents) in bfloat16, halving their memory
    # traffic. Params, LayerNorm
    # statistics, the loss, and the optimizer stay f32 (standard mixed
    # precision); the head returns f32.
    compute_dtype: str = "f32"

    @property
    def k_spatial(self) -> int:
        return int(sum(self.k_spatial_centers))

    @property
    def k_temporal(self) -> int:
        return int(sum(self.k_temporal_centers))

    @property
    def input_dim(self) -> int:
        return self.p + self.k_spatial + self.k_temporal

    @property
    def last_hidden_dim(self) -> int:
        return self.hidden_dims[-1] if self.hidden_dims else self.input_dim

    @property
    def delta_head(self) -> bool:
        return self.use_delta_reparameterization and self.output_dim > 1


# train_dtype='auto' size trigger: the bf16 trunk (halved activation
# traffic) is used once sum(hidden_dims) reaches this width. The value was
# set on another accelerator and is kept so behaviour does not change; the
# GPU measurement that should set it is ROADMAP Speed item 5 (with the
# lane-width trigger batch_engine.AUTO_BF16_LANES, Speed item 3).
AUTO_BF16_HIDDEN_SUM = 1280


def spec_from_config(cfg: ExperimentConfig) -> ModelSpec:
    # ragged-k stacking: the compiled program sees one padded resolution of
    # k_spatial_pad centers; the real multi-resolution layout lives in the
    # lane's cfg (inits, finalize slicing)
    k_spatial = (tuple(cfg.k_spatial_centers) if cfg.k_spatial_pad is None
                 else (int(cfg.k_spatial_pad),))
    return ModelSpec(
        p=cfg.p_covariates,
        k_spatial_centers=k_spatial,
        k_temporal_centers=tuple(cfg.k_temporal_centers),
        hidden_dims=tuple(cfg.hidden_dims),
        dropout=cfg.dropout,
        layernorm=cfg.layernorm,
        spatial_basis_function=cfg.spatial_basis_function,
        spatial_learnable=cfg.spatial_learnable,
        output_dim=cfg.output_dim,
        use_delta_reparameterization=cfg.use_delta_reparameterization,
        # 'auto' resolves by MODEL SIZE here; the batch engine additionally
        # flips wide-lane batches (batch_engine._apply_auto_train_dtype)
        compute_dtype=(("bf16" if sum(cfg.hidden_dims)
                        >= AUTO_BF16_HIDDEN_SUM else "f32")
                       if cfg.train_dtype == "auto" else cfg.train_dtype),
    )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _linear_init(key: jax.Array, fan_in: int, fan_out: int) -> Dict[str, jax.Array]:
    bound = 1.0 / float(np.sqrt(fan_in))
    kw, kb = jax.random.split(key)
    return {
        "w": jax.random.uniform(kw, (fan_in, fan_out), jnp.float32, -bound, bound),
        "b": jax.random.uniform(kb, (fan_out,), jnp.float32, -bound, bound),
    }


def init_model(
    key: jax.Array,
    spec: ModelSpec,
    spatial_centers: Optional[np.ndarray] = None,
    spatial_bandwidths: Optional[np.ndarray] = None,
) -> Tuple[Params, Consts]:
    """Initialize (params, consts).

    spatial_centers/bandwidths default to the uniform multi-resolution grid;
    data-adaptive initializers (GMM / balanced k-means / random-site,
    st_dadk_tpu.ops.init_centers) pass their results in.
    """
    if spatial_centers is None or spatial_bandwidths is None:
        spatial_centers, spatial_bandwidths = uniform_grid_centers(spec.k_spatial_centers)
    spatial_centers = jnp.asarray(spatial_centers, jnp.float32)
    spatial_bandwidths = jnp.asarray(spatial_bandwidths, jnp.float32)
    t_centers, t_bw = temporal_grid_centers(spec.k_temporal_centers)

    consts: Consts = {
        "spatial_centers_init": spatial_centers,
        "spatial_bandwidths_init": spatial_bandwidths,
        "temporal_centers": jnp.asarray(t_centers),
        "temporal_bandwidths": jnp.asarray(t_bw),
    }

    params: Params = {}
    if spec.spatial_learnable:
        params["basis"] = {
            "centers": spatial_centers,
            "log_bandwidths": jnp.log(spatial_bandwidths),
        }

    mlp: Dict[str, Any] = {}
    prev = spec.input_dim
    n_layers = len(spec.hidden_dims)
    keys = jax.random.split(key, n_layers + 1)
    for i, h in enumerate(spec.hidden_dims):
        mlp[f"linear_{i}"] = _linear_init(keys[i], prev, h)
        if spec.layernorm:
            mlp[f"ln_{i}"] = {"scale": jnp.ones((h,), jnp.float32),
                              "bias": jnp.zeros((h,), jnp.float32)}
        prev = h

    if spec.delta_head:
        mlp["delta"] = 0.01 * jax.random.normal(
            keys[-1], (spec.output_dim, prev + 1), jnp.float32)
    else:
        mlp["out"] = _linear_init(keys[-1], prev, spec.output_dim)
    params["mlp"] = mlp
    return params, consts


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def spatial_params(spec: ModelSpec, params: Params, consts: Consts
                   ) -> Tuple[jax.Array, jax.Array]:
    """Current (centers, bandwidths); bandwidth = exp(log_bandwidth) when
    learnable (positivity via log-parameterization, ref st_interp.py:99-150)."""
    if spec.spatial_learnable:
        return params["basis"]["centers"], jnp.exp(params["basis"]["log_bandwidths"])
    return consts["spatial_centers_init"], consts["spatial_bandwidths_init"]


def _embed(spec: ModelSpec, params: Params, consts: Consts,
           coords: jax.Array, t: jax.Array) -> jax.Array:
    centers, bandwidths = spatial_params(spec, params, consts)
    phi = spatial_basis_embed(coords, centers, bandwidths,
                              spec.spatial_basis_function)
    if "spatial_k_mask" in consts:
        # ragged-k lane stacking: zero the padded junk columns so neither the
        # first-layer weight rows nor the junk centers receive gradients —
        # with their zero initialization they then stay exactly zero and the
        # lane's fit tracks its own-shape sequential run (see pad_lane_model)
        phi = phi * consts["spatial_k_mask"]
    psi = temporal_basis_embed(t, consts["temporal_centers"],
                               consts["temporal_bandwidths"])
    return phi, psi


def _cdtype(spec: ModelSpec):
    return jnp.bfloat16 if spec.compute_dtype == "bf16" else jnp.float32


def _dropout_masks(spec: ModelSpec, rng: jax.Array, n: int) -> list:
    """All layers' keep-masks from ONE generator call: the per-layer
    bernoulli calls were three separate RNG kernels per training step; one
    (n, sum(hidden)) draw sliced per layer is the same distribution from
    one kernel (masks stay deterministic per seed; the stream differs from
    the per-layer-split version, which is an implementation detail of the
    mask source, like the rbg re-keying in train.loop)."""
    total = int(sum(spec.hidden_dims))
    keep_all = jax.random.bernoulli(rng, 1.0 - spec.dropout, (n, total))
    masks, off = [], 0
    for hdim in spec.hidden_dims:
        masks.append(keep_all[:, off:off + hdim])
        off += hdim
    return masks


def trunk(spec: ModelSpec, params: Params, features: jax.Array,
          train: bool = False, rng: Optional[jax.Array] = None) -> jax.Array:
    """Hidden MLP: Linear -> LayerNorm -> ReLU -> Dropout per layer.

    With compute_dtype='bf16' the activations flow in bfloat16 (params are
    cast at use; LayerNorm statistics in f32)."""
    cd = _cdtype(spec)
    mlp = params["mlp"]
    h = features.astype(cd)
    use_dropout = train and spec.dropout > 0.0
    if use_dropout:
        if rng is None:
            raise ValueError("rng required for dropout in train mode")
        masks = _dropout_masks(spec, rng, features.shape[0])
    for i in range(len(spec.hidden_dims)):
        lin = mlp[f"linear_{i}"]
        h = h @ lin["w"].astype(cd) + lin["b"].astype(cd)
        if spec.layernorm:
            ln = mlp[f"ln_{i}"]
            h32 = h.astype(jnp.float32)
            mean = jnp.mean(h32, axis=-1, keepdims=True)
            var = jnp.var(h32, axis=-1, keepdims=True)
            h = ((h32 - mean) * jax.lax.rsqrt(var + 1e-5)).astype(cd)
            h = h * ln["scale"].astype(cd) + ln["bias"].astype(cd)
        h = jax.nn.relu(h)
        if use_dropout:
            h = jnp.where(masks[i], h / jnp.asarray(1.0 - spec.dropout, cd),
                          jnp.zeros((), cd))
    return h


def head(spec: ModelSpec, params: Params, h: jax.Array) -> jax.Array:
    mlp = params["mlp"]
    if spec.delta_head:
        beta = jnp.cumsum(mlp["delta"], axis=0)          # (Q, d+1)
        return beta[None, :, 0] + h @ beta[:, 1:].T       # (B, Q)
    out = mlp["out"]
    return h @ out["w"] + out["b"]


def forward(spec: ModelSpec, params: Params, consts: Consts,
            X: Optional[jax.Array], coords: jax.Array, t: jax.Array,
            train: bool = False, rng: Optional[jax.Array] = None) -> jax.Array:
    """yhat(s, t): (B, output_dim)."""
    phi, psi = _embed(spec, params, consts, coords, t)
    if X is not None and spec.p > 0:
        features = jnp.concatenate([X, phi, psi], axis=-1)
    else:
        features = jnp.concatenate([phi, psi], axis=-1)
    h = trunk(spec, params, features, train=train, rng=rng)
    return head(spec, params, h)


# ---------------------------------------------------------------------------
# Penalties (pure functions of params)
# ---------------------------------------------------------------------------

def domain_penalty(spec: ModelSpec, params: Params,
                   bounds: Tuple[float, float] = (0.0, 1.0)) -> jax.Array:
    """Squared violation of centers outside [0,1]^2 (ref st_interp.py:493-525)."""
    if not spec.spatial_learnable:
        return jnp.asarray(0.0, jnp.float32)
    c = params["basis"]["centers"]
    lo, hi = bounds
    violations = jax.nn.relu(lo - c) + jax.nn.relu(c - hi)
    return jnp.sum(violations ** 2)


def movement_penalty(spec: ModelSpec, params: Params, consts: Consts) -> jax.Array:
    """Sum of squared center displacements from init (ref st_interp.py:527-546)."""
    if not spec.spatial_learnable:
        return jnp.asarray(0.0, jnp.float32)
    move = params["basis"]["centers"] - consts["spatial_centers_init"]
    return jnp.sum(move ** 2)


def sparsity_block(wb: jax.Array, penalty_type: str, lambda_l1: float,
                   lambda_group: float) -> jax.Array:
    """Sparsity penalty of ONE first-layer block (rows = basis functions).

    Row-wise math, so a k-sharded block (tensor parallelism) can compute its
    local rows and psum — shared by sparsity_penalty and the TP loss.
    """
    def abs_l1(w: jax.Array) -> jax.Array:
        # torch-parity subgradient: d|w|/dw = 0 at w == 0 (jax.lax.abs uses
        # +1 there). Random init never lands on exact zero, but ragged-k
        # padding keeps junk rows at EXACTLY zero (pad_lane_model) — without
        # this guard the L1 penalty would push them off zero.
        return jnp.where(w != 0, jnp.abs(w), 0.0).sum()

    if penalty_type == "element":
        return lambda_l1 * abs_l1(wb)
    # NaN-safe group norm: d sqrt(s)/dw = w/sqrt(s) is NaN at s == 0.
    # Same exact-zero-row concern as abs_l1; the where-guard leaves
    # values and gradients of nonzero rows bit-identical and gives zero
    # rows a zero gradient instead of NaN.
    s = jnp.sum(wb * wb, axis=1)
    nz = s > 0
    group = jnp.sqrt(jnp.where(nz, s, 1.0)) * nz.astype(wb.dtype)
    if penalty_type == "group":
        return lambda_group * group.sum()
    return lambda_group * group.sum() + lambda_l1 * abs_l1(wb)


def sparsity_penalty(spec: ModelSpec, params: Params, penalty_type: str,
                     lambda_l1: float, lambda_group: float) -> Dict[str, jax.Array]:
    """First-layer sparsity penalties split by spatial/temporal input blocks.

    Weight layout here is (in, out); the per-basis group is a row, i.e. the
    weight vector of one basis function across hidden units — identical to the
    reference's transposed (k, hidden) blocks (ref st_interp.py:724-825).
    """
    zero = jnp.asarray(0.0, jnp.float32)
    if penalty_type == "none":
        return {"spatial_penalty": zero, "temporal_penalty": zero,
                "total_penalty": zero}
    if penalty_type not in ("element", "group", "sparse_group"):
        raise ValueError(f"Unknown penalty_type: {penalty_type}")

    w0 = params["mlp"]["linear_0"]["w"]                  # (in, hidden)
    idx = spec.p
    spatial_w = w0[idx: idx + spec.k_spatial]            # (k_s, hidden)
    idx += spec.k_spatial
    temporal_w = w0[idx: idx + spec.k_temporal]          # (k_t, hidden)

    sp = sparsity_block(spatial_w, penalty_type, lambda_l1, lambda_group)
    tp = sparsity_block(temporal_w, penalty_type, lambda_l1, lambda_group)
    return {"spatial_penalty": sp, "temporal_penalty": tp,
            "total_penalty": sp + tp}


def count_parameters(params: Params) -> int:
    return int(sum(np.prod(p.shape) for p in jax.tree_util.tree_leaves(params)))


# ---------------------------------------------------------------------------
# Ragged-k lane padding (SURVEY §7.1 step 6: grid configs with different
# k_spatial_centers stack into one padded vmapped program)
# ---------------------------------------------------------------------------

def pad_lane_model(spec_real: ModelSpec, k_pad: int, params: Params,
                   consts: Consts) -> Tuple[Params, Consts]:
    """Pad a REAL-shape (params, consts) pair to a k_pad-wide spatial basis.

    Invariants that make the padded lane's fit track its own-shape
    sequential run (up to matmul reduction order):
      - real centers/bandwidths/weight-rows occupy the leading rows; the
        `spatial_k_mask` in consts zeroes phi's junk columns, so junk rows of
        the first-layer weights and junk centers receive ZERO gradients;
      - junk centers/log-bandwidths/weight-rows are initialized to exactly 0
        (bandwidth 1 in linear space), so AdamW's decoupled weight decay
        (p *= 1-lr*wd) keeps them at exactly 0 and every penalty (domain,
        movement, sparsity group norms) sees zero contribution from them.
    """
    k = spec_real.k_spatial
    pad = k_pad - k
    if pad < 0:
        raise ValueError(f"k_pad {k_pad} < real k {k}")

    def pad0(x, rows):
        return jnp.concatenate(
            [x, jnp.zeros((rows,) + tuple(x.shape[1:]), x.dtype)], axis=0)

    new_consts = dict(consts)
    new_consts["spatial_centers_init"] = pad0(
        jnp.asarray(consts["spatial_centers_init"]), pad)
    new_consts["spatial_bandwidths_init"] = jnp.concatenate(
        [jnp.asarray(consts["spatial_bandwidths_init"]),
         jnp.ones((pad,), jnp.float32)])
    new_consts["spatial_k_mask"] = (
        jnp.arange(k_pad) < k).astype(jnp.float32)

    new_params = {k2: dict(v) for k2, v in params.items()}
    if "basis" in new_params:
        b = new_params["basis"]
        b["centers"] = pad0(jnp.asarray(b["centers"]), pad)
        b["log_bandwidths"] = jnp.concatenate(
            [jnp.asarray(b["log_bandwidths"]), jnp.zeros((pad,), jnp.float32)])
    lin0 = dict(new_params["mlp"]["linear_0"])
    w = jnp.asarray(lin0["w"])                 # (p + k + k_t, H)
    cut = spec_real.p + k
    lin0["w"] = jnp.concatenate(
        [w[:cut], jnp.zeros((pad, w.shape[1]), w.dtype), w[cut:]], axis=0)
    new_params["mlp"]["linear_0"] = lin0
    return new_params, new_consts


def strip_lane_padding(spec_real: ModelSpec, k_pad: int, params: Params,
                       consts: Consts) -> Tuple[Params, Consts]:
    """Inverse of pad_lane_model for finalize: slice the real rows back out
    so artifacts (model_final.npz, basis_info.npz, plots) carry the lane's
    true shapes."""
    k = spec_real.k_spatial
    new_consts = dict(consts)
    new_consts["spatial_centers_init"] = np.asarray(
        consts["spatial_centers_init"])[:k]
    new_consts["spatial_bandwidths_init"] = np.asarray(
        consts["spatial_bandwidths_init"])[:k]
    new_consts.pop("spatial_k_mask", None)

    new_params = {k2: dict(v) for k2, v in params.items()}
    if "basis" in new_params:
        b = new_params["basis"]
        b["centers"] = np.asarray(b["centers"])[:k]
        b["log_bandwidths"] = np.asarray(b["log_bandwidths"])[:k]
    lin0 = dict(new_params["mlp"]["linear_0"])
    w = np.asarray(lin0["w"])
    cut = spec_real.p + k
    lin0["w"] = np.concatenate([w[:cut], w[spec_real.p + k_pad:]], axis=0)
    new_params["mlp"]["linear_0"] = lin0
    return new_params, new_consts
