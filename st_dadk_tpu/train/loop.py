"""The training loop as one jitted XLA program.

The reference trains with a Python epoch/batch loop around torch (~16 tiny
optimizer steps per epoch x 500 epochs, train_st_interp.py:463-881). Here the
*entire fit* — minibatch sampling, forward/backward, AdamW, EMA, EMA-swap
validation, best-checkpoint tracking, early stopping, the NaN-guard — is a
`lax.scan` over epochs of a `lax.scan` over batches, compiled once. A fit that
takes minutes on CPU runs in seconds on one accelerator, and the whole function
vmaps over a leading experiment axis (see st_dadk_tpu.train.batch_engine).

Replicated reference semantics:
  - per-epoch reshuffle, ceil(n/batch) batches, ragged last batch (weighted)
  - EMA update after every optimizer step; decay = 1 - 1/(10*batches_per_epoch)
    (:537-540); validation runs with EMA weights swapped in (:737-790)
  - best checkpoint stores the EMA params at the best val loss (:828-836)
  - early stopping on `patience` epochs without val improvement (:852-857)
  - per-group clipping: basis at 0.1x the MLP clip (:696-707)
  - distance-based gradient damping on centers (st_interp.py:111-142)
  - NaN loss poisons that step (the reference steps the optimizer before
    checking, :693-733) and skips the rest of the epoch's batches
  - composite loss: main + non-crossing (pred- or delta-level) + domain +
    movement + sparsity (:619-691)

Static shapes: training points live in padded buffers with 0/1 weights; lanes
with fewer real batches mask the surplus steps, so vmapped experiments with
slightly different observation counts stay bit-faithful per lane.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet, pad_pointset, round_up
from st_dadk_tpu.models.st_interp import (
    ModelSpec,
    domain_penalty,
    forward,
    movement_penalty,
    sparsity_penalty,
)
from st_dadk_tpu.ops.losses import (
    mse_loss,
    multi_quantile_loss,
    non_crossing_penalty,
    p_nc_delta_penalty,
    quantile_loss,
)
from st_dadk_tpu.train.optimizer import (
    adamw_init,
    adamw_update,
    build_lr_tables,
    clip_by_global_norm,
    ema_update,
    gradient_damping,
    lr_tree_for,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class LoopSpec:
    """Static (hashable) training-loop configuration."""
    model: ModelSpec
    regression_type: str = "mean"
    quantile_levels: Tuple[float, ...] = (0.1, 0.5, 0.9)
    current_quantile: Optional[float] = None
    non_crossing_weight: float = 0.0
    non_crossing_power: int = 1
    non_crossing_lambda: float = 0.0
    non_crossing_delta_mode: str = "eq310"
    domain_penalty_weight: float = 0.0
    movement_penalty_weight: float = 0.0
    sparsity_penalty_type: str = "none"
    sparsity_lambda_l1: float = 0.001
    sparsity_lambda_group: float = 0.01
    sparsity_apply_to_spatial: bool = True
    sparsity_apply_to_temporal: bool = True
    gradient_damping: bool = False
    damping_threshold: float = 0.3
    damping_strength: float = 1.0
    grad_clip: float = 0.0
    weight_decay: float = 1e-5
    batch_size: int = 256
    n_batches: int = 1            # shared (max) batches per epoch
    epochs: int = 100
    patience: int = 15
    # plateau-slope stop threshold (config.early_stop_min_rel_delta): the
    # patience counter resets only when val_loss beats the last significant
    # anchor by more than this relative margin. 0.0 = exact reference
    # any-improvement semantics (the sig-anchor then tracks best_val).
    min_rel_delta: float = 0.0
    val_chunk: int = 32768        # validation batch size
    n_val_chunks: int = 1
    record_centers: bool = False
    dp_axis: Optional[str] = None  # mesh axis for batch-dim data parallelism
    # static promise that every lane's real batch count equals n_batches —
    # lets the epoch shuffle skip the (sort-based) stable partition that
    # protects lanes with fewer real batches (see epoch_batch_indices)
    uniform_lanes: bool = True
    # record the basis-center trajectory only every Nth epoch ON DEVICE
    # (the reference samples every 100 epochs anyway, train_st_interp.py
    # :573-575); keeps the per-chunk history transfer small. Must divide the
    # chunk length; 1 = dense recording.
    centers_every: int = 1
    # dropout mask stream: 'rbg' re-keys the per-epoch dropout key into
    # lax.rng_bit_generator (Philox on the GPU); 'threefry' keeps the jax
    # default (round-1 behavior). Which is cheaper on the GPU is open
    # (ROADMAP Speed item 6). Under vmap jax draws every lane's 'rbg' bits
    # from the batch's FIRST lane key, so a lane's 'rbg' masks depend on its
    # batch mates; threefry masks are a function of the lane's own key.
    dropout_rng: str = "rbg"
    # run AdamW/EMA/clip/select on flat-packed param groups inside the scan
    # (train.packing): identical math per element (clip's reduction order
    # differs within f32 rounding); opt-in, off by default like
    # config.py::packed_optimizer.
    packed_opt: bool = False
    # unroll factor for the per-epoch batch-step lax.scan (config default 1)
    scan_unroll: int = 1
    # gather the epoch's minibatches once per epoch instead of per step
    pregather: bool = True
    # rematerialize the training forward in the backward pass
    # (jax.checkpoint): the step keeps no activation residuals live, trading
    # ~1/3 more matmul FLOPs for a much smaller per-step working set (a
    # lever for WIDE lane batches).
    remat: bool = False
    # epoch shuffle source:
    #   'auto' (default) = 'hash' when lanes are uniform (any capacity;
    #       non-pow2 caps compact a pow2 bijection), else 'perm';
    #   'hash' = keyed multiply-xorshift bijection on [0, cap) — an exact
    #       permutation computed with a handful of elementwise integer ops
    #       instead of the per-epoch SORT (the compiled epoch drops both
    #       sort ops). A different
    #       (pseudorandom) order than 'perm', so per-epoch batch
    #       composition — like the torch DataLoader's — matches the
    #       reference statistically, not bitwise;
    #   'perm' = uniform random permutation via sort (round-1/2 behavior);
    #   'none' = identity order (ABLATION ONLY — breaks SGD shuffling).
    shuffle: str = "auto"
    # ABLATION ONLY: skip per-epoch validation (val_loss := train proxy);
    # breaks early-stop/best-EMA semantics, valid only for timing chunks
    ablate_validate: bool = False

    @classmethod
    def from_config(cls, cfg: ExperimentConfig, model: ModelSpec,
                    batch_size: int, n_batches: int, val_chunk: int,
                    n_val_chunks: int) -> "LoopSpec":
        return cls(
            model=model,
            regression_type=cfg.regression_type,
            quantile_levels=tuple(cfg.quantile_levels),
            current_quantile=cfg.current_quantile,
            non_crossing_weight=cfg.non_crossing_weight,
            non_crossing_power=cfg.non_crossing_power,
            non_crossing_lambda=cfg.non_crossing_lambda,
            non_crossing_delta_mode=cfg.non_crossing_delta_mode,
            domain_penalty_weight=cfg.domain_penalty_weight,
            movement_penalty_weight=cfg.movement_penalty_weight,
            sparsity_penalty_type=cfg.sparsity_penalty_type,
            sparsity_lambda_l1=cfg.sparsity_lambda_l1,
            sparsity_lambda_group=cfg.sparsity_lambda_group,
            sparsity_apply_to_spatial=cfg.sparsity_apply_to_spatial,
            sparsity_apply_to_temporal=cfg.sparsity_apply_to_temporal,
            gradient_damping=cfg.gradient_damping,
            damping_threshold=cfg.damping_threshold,
            damping_strength=cfg.damping_strength,
            grad_clip=cfg.grad_clip,
            weight_decay=cfg.weight_decay,
            batch_size=batch_size,
            n_batches=n_batches,
            epochs=cfg.epochs,
            patience=cfg.patience,
            min_rel_delta=cfg.early_stop_min_rel_delta,
            val_chunk=val_chunk,
            n_val_chunks=n_val_chunks,
            record_centers=cfg.spatial_learnable,
            dropout_rng=cfg.dropout_rng,
            packed_opt=cfg.packed_optimizer,
            scan_unroll=cfg.scan_unroll,
            pregather=bool(cfg.extra.get("pregather", True)),
            remat=bool(cfg.extra.get("remat", False)),
            shuffle=str(cfg.extra.get("shuffle", "auto")),
            ablate_validate=bool(cfg.extra.get("ablate_validate", False)),
        )


class TrainData(NamedTuple):
    """Per-lane dynamic training inputs (all jnp arrays; vmappable)."""
    tr_coords: jax.Array   # (cap_tr, 2)
    tr_t: jax.Array        # (cap_tr, 1)
    tr_y: jax.Array        # (cap_tr, 1)
    tr_w: jax.Array        # (cap_tr,)
    va_coords: jax.Array   # (cap_va, 2)
    va_t: jax.Array
    va_y: jax.Array
    va_w: jax.Array
    n_batches: jax.Array   # () int32 — this lane's real batches/epoch
    ema_decay: jax.Array   # () float32


# ---------------------------------------------------------------------------
# Loss assembly
# ---------------------------------------------------------------------------

def training_loss(spec: LoopSpec, params: Params, consts: Dict[str, Any],
                  coords: jax.Array, t: jax.Array, y: jax.Array,
                  w: jax.Array, train: bool, rng: Optional[jax.Array]
                  ) -> jax.Array:
    """Composite objective (ref train_st_interp.py:619-691; val :753-783)."""
    m = spec.model
    if spec.remat and train:
        fwd = jax.checkpoint(
            lambda p, c, tt: forward(m, p, consts, None, c, tt,
                                     train=True, rng=rng))
        preds = fwd(params, coords, t)
    else:
        preds = forward(m, params, consts, None, coords, t, train=train,
                        rng=rng)
    return loss_from_preds(spec, params, consts, preds, y, w, train)


def loss_from_preds(spec: LoopSpec, params: Params, consts: Dict[str, Any],
                    preds: jax.Array, y: jax.Array, w: jax.Array,
                    train: bool) -> jax.Array:
    """Composite objective given the forward's predictions (lets validation
    share one forward between its loss and its RMSE predictions)."""
    m = spec.model
    if spec.regression_type == "mean":
        loss = mse_loss(preds, y, w)
    elif spec.regression_type == "quantile":
        if spec.current_quantile is not None:
            tau = float(spec.current_quantile)
        else:
            # per-lane runtime quantile: stacked per-tau lanes share ONE
            # compiled program with tau as lane data (batch engine sets
            # consts['tau'] and clears spec.current_quantile)
            tau = consts["tau"]
        loss = quantile_loss(preds, y, tau, w)
    elif spec.regression_type == "multi-quantile":
        q = jnp.asarray(spec.quantile_levels, jnp.float32)
        loss = multi_quantile_loss(preds, y, q, w)
        if m.use_delta_reparameterization and m.delta_head:
            if spec.non_crossing_lambda > 0:
                p_nc = p_nc_delta_penalty(params["mlp"]["delta"])
                if spec.non_crossing_delta_mode == "abs":
                    # opt-in sign fix (the reference's own TODO, :107-110):
                    # penalize infeasibility instead of rewarding it
                    p_nc = -p_nc
                loss = loss + spec.non_crossing_lambda * p_nc
        else:
            if spec.non_crossing_weight > 0:
                loss = loss + spec.non_crossing_weight * non_crossing_penalty(
                    preds, "mean", spec.non_crossing_power, weights=w)
    else:
        raise ValueError(f"Unknown regression_type: {spec.regression_type}")

    if train:
        if m.spatial_learnable:
            if spec.domain_penalty_weight > 0:
                loss = loss + spec.domain_penalty_weight * domain_penalty(m, params)
            if spec.movement_penalty_weight > 0:
                loss = loss + spec.movement_penalty_weight * movement_penalty(
                    m, params, consts)
        if spec.sparsity_penalty_type != "none":
            pen = sparsity_penalty(m, params, spec.sparsity_penalty_type,
                                   spec.sparsity_lambda_l1,
                                   spec.sparsity_lambda_group)
            if spec.sparsity_apply_to_spatial:
                loss = loss + pen["spatial_penalty"]
            if spec.sparsity_apply_to_temporal:
                loss = loss + pen["temporal_penalty"]
    return loss


def _transform_grads(spec: LoopSpec, grads: Params, params: Params,
                     consts: Dict[str, Any]) -> Params:
    """Gradient damping on centers, then per-group global-norm clipping."""
    m = spec.model
    if m.spatial_learnable and spec.gradient_damping:
        g = dict(grads)
        basis = dict(g["basis"])
        basis["centers"] = gradient_damping(
            basis["centers"], params["basis"]["centers"],
            consts["spatial_centers_init"], spec.damping_threshold,
            spec.damping_strength)
        g["basis"] = basis
        grads = g
    if spec.grad_clip > 0:
        if m.spatial_learnable:
            g = dict(grads)
            g["basis"] = clip_by_global_norm(grads["basis"], spec.grad_clip * 0.1)
            rest = {k: v for k, v in grads.items() if k != "basis"}
            rest = clip_by_global_norm(rest, spec.grad_clip)
            g.update(rest)
            grads = g
        else:
            grads = clip_by_global_norm(grads, spec.grad_clip)
    return grads


# ---------------------------------------------------------------------------
# Validation (EMA weights, dropout off)
# ---------------------------------------------------------------------------

def _validate(spec: LoopSpec, ema: Params, consts: Dict[str, Any],
              data: TrainData, mesh=None) -> Tuple[jax.Array, jax.Array]:
    """Return (val_loss, val_rmse).

    val_loss is the mean over validation chunks of per-chunk mean losses
    (the reference averages per-batch means, :785-792). val_rmse is the
    global RMSE of the median-quantile predictions (:794-806).
    """
    m = spec.model
    C, K = spec.val_chunk, spec.n_val_chunks
    coords = data.va_coords.reshape(K, C, 2)
    t = data.va_t.reshape(K, C, 1)
    y = data.va_y.reshape(K, C, 1)
    w = data.va_w.reshape(K, C)

    def chunk_stats(carry, xs):
        ck, tk, yk, wk = xs
        ck, tk, yk, wk = _dp_shard(spec, mesh, ck, tk, yk, wk)
        preds = forward(m, ema, consts, None, ck, tk, train=False)
        loss = loss_from_preds(spec, ema, consts, preds, yk, wk, train=False)
        if spec.regression_type == "multi-quantile":
            median_idx = len(spec.quantile_levels) // 2
            p_for_rmse = preds[:, median_idx:median_idx + 1]
        else:
            p_for_rmse = preds
        se = jnp.sum((p_for_rmse - yk) ** 2 * wk[:, None])
        cnt = jnp.sum(wk)
        has_real = (cnt > 0).astype(jnp.float32)
        return carry, (loss * has_real, has_real, se, cnt)

    _, (losses, valid, se, cnt) = jax.lax.scan(
        chunk_stats, None, (coords, t, y, w))
    val_loss = jnp.sum(losses) / jnp.maximum(jnp.sum(valid), 1.0)
    val_rmse = jnp.sqrt(jnp.sum(se) / jnp.maximum(jnp.sum(cnt), 1.0))
    return val_loss, val_rmse


# ---------------------------------------------------------------------------
# Epoch
# ---------------------------------------------------------------------------

def _dp_shard(spec: LoopSpec, mesh, *arrays):
    """Constrain the leading (point) axis of batch tensors to the DP mesh
    axis. Params and the carry stay replicated, so XLA's sharding propagation
    turns the backward pass into sharded per-device gradients + ONE
    all-reduce per step — textbook data parallelism, expressed as sharding
    annotations on the single shared training-loop program rather than a
    separate shard_map code path (SURVEY.md section 2.4 row 3).

    The training buffers themselves are replicated (KAUST datasets are at
    most ~MBs), so the reshard after the minibatch gather is a local slice
    with zero communication.
    """
    if mesh is None or spec.dp_axis is None:
        return arrays
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = []
    for a in arrays:
        s = NamedSharding(mesh, P(spec.dp_axis, *([None] * (a.ndim - 1))))
        out.append(jax.lax.with_sharding_constraint(a, s))
    return tuple(out)


def epoch_batch_indices(perm_key: jax.Array, cap: int, bs: int, B: int,
                        n_batches_lane: jax.Array,
                        uniform: bool = False,
                        shuffle: str = "perm") -> jax.Array:
    """(B, bs) shuffled point indices for one epoch.

    In a stacked batch a lane may have fewer real batches than the shared
    capacity (B_lane < B). Only batches b < B_lane execute, so real points
    permuted into the surplus batches would silently be skipped this epoch.
    Stable-partition the permutation so the lane's own capacity
    (B_lane*bs indices, a superset of its real points) fills the executed
    batches — filtering a uniform permutation preserves uniformity, and when
    B_lane == B the partition is the identity reorder.

    `uniform=True` is the caller's static promise that B_lane == B for every
    lane; the partition (an argsort, a measurable fraction of a small
    model's step time) is skipped entirely.

    `shuffle='hash'`/'auto' replaces the sort-based permutation with a keyed
    multiply-xorshift bijection (see `hash_permutation_any`) when lanes are
    uniform; `shuffle='none'` (ablation only) skips shuffling entirely —
    for measuring the shuffle+gather share of the epoch scan.
    """
    if shuffle == "none":
        return jnp.arange(B * bs, dtype=jnp.int32).reshape(B, bs) % cap
    if shuffle in ("auto", "hash") and uniform:
        perm = hash_permutation_any(perm_key, cap)
        return perm[: B * bs].reshape(B, bs)
    perm = jax.random.permutation(perm_key, cap)
    if not uniform:
        cap_lane = n_batches_lane * bs
        perm = perm[jnp.argsort(perm >= cap_lane, stable=True)]
    return perm[: B * bs].reshape(B, bs)


def hash_permutation(key: jax.Array, cap: int) -> jax.Array:
    """Keyed exact permutation of [0, cap) for power-of-two cap, sort-free.

    Three rounds of (odd-multiply mod 2^w, xorshift-right) with per-epoch
    random odd multipliers. Each step is invertible on w-bit integers
    (odd numbers are units mod 2^w; xorshift-right is upper-triangular
    unipotent over GF(2)), so the composition is a bijection — an exact
    permutation computed with ~10 elementwise integer ops instead of the
    sort `jax.random.permutation` lowers to. uint32 products wrap mod 2^32, and since 2^w divides 2^32 the
    wrapped product is still correct mod 2^w.

    The reference shuffles with torch's DataLoader (an unrelated PRNG), so
    batch-composition parity is statistical either way."""
    w = int(cap).bit_length() - 1
    mask = jnp.uint32(cap - 1)
    r = jax.random.randint(key, (4,), 0, cap, dtype=jnp.int32).astype(
        jnp.uint32)
    s1, s2 = max(1, w // 2), max(1, w // 3)
    x = jnp.arange(cap, dtype=jnp.uint32)
    x = x ^ (r[3] & mask)
    for i in range(3):
        x = (x * (2 * r[i] + 1)) & mask
        x = x ^ (x >> s1 if i % 2 == 0 else x >> s2)
    return x.astype(jnp.int32)


def hash_permutation_any(key: jax.Array, cap: int) -> jax.Array:
    """Sort-free keyed permutation of [0, cap) for ANY cap.

    Power-of-two caps use `hash_permutation` directly. Otherwise the
    bijection runs on the next power of two and the entries >= cap are
    compacted out with one cumsum + one scatter over <= 2*cap elements —
    still far cheaper than the sort that `jax.random.permutation` lowers
    to. The result is the big
    permutation's order restricted to [0, cap), so it inherits the hash
    family's uniformity."""
    if (cap & (cap - 1)) == 0:
        return hash_permutation(key, cap)
    big_n = 1 << int(cap).bit_length()
    big = hash_permutation(key, big_n)
    mask = big < cap
    pos = jnp.cumsum(mask) - 1
    out = jnp.zeros(cap, jnp.int32)
    return out.at[jnp.where(mask, pos, cap)].set(big, mode="drop")


def _run_epoch(spec: LoopSpec, consts: Dict[str, Any], data: TrainData,
               carry: Dict[str, Any],
               epoch_xs: Tuple[jax.Array, jax.Array, jax.Array],
               mesh=None) -> Tuple[Dict[str, Any], Dict[str, jax.Array]]:
    epoch_idx, lr_epoch, active = epoch_xs    # lr_epoch: (n_batches, 2)
    m = spec.model
    B = spec.n_batches
    bs = spec.batch_size
    cap = data.tr_coords.shape[0]

    key = jax.random.fold_in(carry["key"], epoch_idx)
    perm_key, drop_key = jax.random.split(key)
    batch_idx = epoch_batch_indices(perm_key, cap, bs, B, data.n_batches,
                                    uniform=spec.uniform_lanes,
                                    shuffle=spec.shuffle)
    if spec.dropout_rng == "rbg" and m.dropout > 0.0:
        # re-key the dropout stream into the RBG generator: the
        # carry/permutation keys stay threefry (checkpoint format unchanged),
        # only mask bits come from lax.rng_bit_generator
        kd = (jax.random.key_data(drop_key)
              if jnp.issubdtype(drop_key.dtype, jax.dtypes.prng_key)
              else drop_key)
        drop_key = jax.random.wrap_key_data(jnp.concatenate([kd, kd]),
                                            impl="rbg")

    # gather the epoch's minibatches once (identical values; the per-step
    # gathers become scan xs slices). The dp path keeps per-step gathers so
    # its batch sharding constraint applies where it did before.
    pregather = spec.pregather and spec.dp_axis is None
    if pregather:
        # pack the four point arrays into ONE (cap, 5) row before the
        # shuffled gather: one width-5 gather instead of four narrow ones
        # (row widths 2/1/1/1 f32); the pack itself is a ~160 KB concat,
        # free at epoch scale
        packed = jnp.concatenate(
            [data.tr_coords, data.tr_t, data.tr_y, data.tr_w[:, None]],
            axis=1)[batch_idx]                      # (B, bs, 5)
        xs_all = (packed[..., 0:2], packed[..., 2:3], packed[..., 3:4],
                  packed[..., 4], lr_epoch,
                  jnp.arange(B, dtype=jnp.int32))
    else:
        xs_all = (batch_idx, lr_epoch, jnp.arange(B, dtype=jnp.int32))

    def train_step(step_carry, xs):
        params, opt_state, ema, nan_epoch, loss_sum = step_carry
        if pregather:
            coords, t, y, w, lrs, b = xs
        else:
            idx, lrs, b = xs
            coords, t, y, w = _dp_shard(spec, mesh, data.tr_coords[idx],
                                        data.tr_t[idx], data.tr_y[idx],
                                        data.tr_w[idx])
        rng = jax.random.fold_in(drop_key, b)

        loss, grads = jax.value_and_grad(
            lambda p: training_loss(spec, p, consts, coords, t, y, w,
                                    train=True, rng=rng))(params)
        grads = _transform_grads(spec, grads, params, consts)
        lr_tree = lr_tree_for(params, lrs[0], lrs[1])
        new_params, new_opt = adamw_update(params, grads, opt_state, lr_tree,
                                           spec.weight_decay)
        new_ema = ema_update(ema, new_params, data.ema_decay)

        # a step executes if: within this lane's real batch count AND the
        # epoch hasn't been NaN-poisoned by an earlier batch (ref :723-733
        # breaks out of the batch loop after a NaN loss)
        executes = jnp.logical_and(b < data.n_batches,
                                   jnp.logical_not(nan_epoch))
        sel = lambda new, old: jax.tree_util.tree_map(
            lambda a, c: jnp.where(executes, a, c), new, old)
        params = sel(new_params, params)
        opt_state = sel(new_opt, opt_state)
        ema = sel(new_ema, ema)
        loss_sum = loss_sum + jnp.where(executes, loss, 0.0)
        nan_epoch = jnp.logical_or(
            nan_epoch, jnp.logical_and(executes, ~jnp.isfinite(loss)))
        return (params, opt_state, ema, nan_epoch, loss_sum), None

    step_init = (carry["params"], carry["opt_state"], carry["ema"],
                 jnp.asarray(False), jnp.asarray(0.0, jnp.float32))
    (params, opt_state, ema, nan_epoch, loss_sum), _ = jax.lax.scan(
        train_step, step_init, xs_all, unroll=spec.scan_unroll)

    train_loss = loss_sum / jnp.maximum(data.n_batches.astype(jnp.float32), 1.0)
    train_loss = jnp.where(nan_epoch, jnp.nan, train_loss)

    if spec.ablate_validate:
        val_loss, val_rmse = train_loss, jnp.asarray(0.0, jnp.float32)
    else:
        val_loss, val_rmse = _validate(spec, ema, consts, data, mesh=mesh)

    improved, was_stopped, scalars = _epoch_bookkeeping(
        spec, carry, val_loss, epoch_idx, active)
    best_ema = jax.tree_util.tree_map(
        lambda new, old: jnp.where(improved, new, old), ema, carry["best_ema"])
    keep = lambda new, old: jax.tree_util.tree_map(
        lambda a, c: jnp.where(was_stopped, c, a), new, old)
    new_carry = {
        "params": keep(params, carry["params"]),
        "opt_state": keep(opt_state, carry["opt_state"]),
        "ema": keep(ema, carry["ema"]),
        "best_ema": keep(best_ema, carry["best_ema"]),
        **scalars,
    }
    hist = _epoch_hist(was_stopped, train_loss, val_loss, val_rmse)
    if spec.record_centers:
        hist["centers"] = new_carry["params"]["basis"]["centers"]
    return new_carry, hist


def _epoch_bookkeeping(spec: LoopSpec, carry: Dict[str, Any],
                       val_loss: jax.Array, epoch_idx: jax.Array,
                       active: jax.Array):
    """End-of-epoch early-stop/best-val scalar bookkeeping, shared verbatim
    by the structured (_run_epoch) and packed (_run_epoch_packed) bodies so
    the two cannot drift. Returns (improved, was_stopped, scalars) where
    `scalars` holds the keep-masked scalar carry entries; the caller applies
    `improved`/`was_stopped` to its own param-tree layout."""
    improved = jnp.logical_and(jnp.isfinite(val_loss),
                               val_loss < carry["best_val"])
    best_val = jnp.where(improved, val_loss, carry["best_val"])
    has_best = jnp.logical_or(carry["has_best"], improved)
    # plateau-slope stop (config.early_stop_min_rel_delta): patience resets
    # only on SIGNIFICANT improvement past the sig anchor. At the 0.0
    # default, sig_best's update trajectory equals best_val's, so
    # sig_improved == improved and the reference's any-improvement patience
    # is reproduced bit-exactly.
    # (sig_best starts at +inf: d*|inf| = NaN — even 0.0*inf — so the
    # anchor-margin applies only once a finite anchor exists)
    sig_thresh = jnp.where(
        jnp.isfinite(carry["sig_best"]),
        carry["sig_best"] - spec.min_rel_delta * jnp.abs(carry["sig_best"]),
        carry["sig_best"])
    sig_improved = jnp.logical_and(jnp.isfinite(val_loss),
                                   val_loss < sig_thresh)
    sig_best = jnp.where(sig_improved, val_loss, carry["sig_best"])
    patience_ctr = jnp.where(sig_improved, 0, carry["patience_ctr"] + 1)
    stop_now = patience_ctr >= spec.patience
    stopped = jnp.logical_or(carry["stopped"], stop_now)
    stop_epoch = jnp.where(
        jnp.logical_and(stop_now, jnp.logical_not(carry["stopped"])),
        epoch_idx + 1, carry["stop_epoch"])

    # lanes that had already stopped keep their previous state entirely;
    # inactive (padding) epochs at the tail of a partial chunk likewise
    was_stopped = jnp.logical_or(carry["stopped"], jnp.logical_not(active))
    scalars = {
        "best_val": jnp.where(was_stopped, carry["best_val"], best_val),
        "sig_best": jnp.where(was_stopped, carry["sig_best"], sig_best),
        "has_best": jnp.where(was_stopped, carry["has_best"], has_best),
        "patience_ctr": jnp.where(was_stopped, carry["patience_ctr"],
                                  patience_ctr),
        "stopped": jnp.where(was_stopped, carry["stopped"], stopped),
        "stop_epoch": jnp.where(was_stopped, carry["stop_epoch"], stop_epoch),
        "key": carry["key"],
    }
    return improved, was_stopped, scalars


def _epoch_hist(was_stopped: jax.Array, train_loss: jax.Array,
                val_loss: jax.Array, val_rmse: jax.Array
                ) -> Dict[str, jax.Array]:
    return {
        "train_loss": jnp.where(was_stopped, jnp.nan, train_loss),
        "val_loss": jnp.where(was_stopped, jnp.nan, val_loss),
        "val_rmse": jnp.where(was_stopped, jnp.nan, val_rmse),
    }


# ---------------------------------------------------------------------------
# Packed-group epoch (train.packing): same semantics as _run_epoch, with the
# optimizer/EMA/select machinery running on two flat vectors instead of ~15
# small leaves. Used inside one fit-chunk dispatch only; the external carry
# keeps the structured layout (checkpoints/pulls unchanged).
# ---------------------------------------------------------------------------

def _pack_carry(ps, carry: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "pk": ps.pack(carry["params"]),
        "mk": ps.pack(carry["opt_state"]["m"]),
        "vk": ps.pack(carry["opt_state"]["v"]),
        "ek": ps.pack(carry["ema"]),
        "bk": ps.pack(carry["best_ema"]),
        "step": carry["opt_state"]["step"],
        "best_val": carry["best_val"],
        "sig_best": carry["sig_best"],
        "has_best": carry["has_best"],
        "patience_ctr": carry["patience_ctr"],
        "stopped": carry["stopped"],
        "stop_epoch": carry["stop_epoch"],
        "key": carry["key"],
    }


def _unpack_carry(ps, pc: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "params": ps.unpack(pc["pk"]),
        "opt_state": {"m": ps.unpack(pc["mk"]), "v": ps.unpack(pc["vk"]),
                      "step": pc["step"]},
        "ema": ps.unpack(pc["ek"]),
        "best_ema": ps.unpack(pc["bk"]),
        "best_val": pc["best_val"],
        "sig_best": pc["sig_best"],
        "has_best": pc["has_best"],
        "patience_ctr": pc["patience_ctr"],
        "stopped": pc["stopped"],
        "stop_epoch": pc["stop_epoch"],
        "key": pc["key"],
    }


def _run_epoch_packed(spec: LoopSpec, ps, consts: Dict[str, Any],
                      data: TrainData, carry: Dict[str, Any],
                      epoch_xs: Tuple[jax.Array, jax.Array, jax.Array],
                      mesh=None) -> Tuple[Dict[str, Any], Dict[str, jax.Array]]:
    from st_dadk_tpu.train.packing import packed_adamw, packed_clip

    epoch_idx, lr_epoch, active = epoch_xs    # lr_epoch: (n_batches, 2)
    m = spec.model
    B = spec.n_batches
    bs = spec.batch_size
    cap = data.tr_coords.shape[0]
    k = m.k_spatial

    key = jax.random.fold_in(carry["key"], epoch_idx)
    perm_key, drop_key = jax.random.split(key)
    batch_idx = epoch_batch_indices(perm_key, cap, bs, B, data.n_batches,
                                    uniform=spec.uniform_lanes,
                                    shuffle=spec.shuffle)
    if spec.dropout_rng == "rbg" and m.dropout > 0.0:
        kd = (jax.random.key_data(drop_key)
              if jnp.issubdtype(drop_key.dtype, jax.dtypes.prng_key)
              else drop_key)
        drop_key = jax.random.wrap_key_data(jnp.concatenate([kd, kd]),
                                            impl="rbg")

    # pre-gather the whole epoch's minibatches in ONE kernel per tensor (the
    # per-step gathers cost 4 kernels x B per epoch; identical values). The
    # dp path keeps per-step gathers so its sharding constraint stays as-is.
    pregather = spec.pregather and spec.dp_axis is None
    if pregather:
        ep_coords = data.tr_coords[batch_idx]          # (B, bs, 2)
        ep_t = data.tr_t[batch_idx]
        ep_y = data.tr_y[batch_idx]
        ep_w = data.tr_w[batch_idx]
        xs_all = (ep_coords, ep_t, ep_y, ep_w, lr_epoch,
                  jnp.arange(B, dtype=jnp.int32))
    else:
        xs_all = (batch_idx, lr_epoch, jnp.arange(B, dtype=jnp.int32))

    damping_on = m.spatial_learnable and spec.gradient_damping
    lr_col = {"mlp": 0, "basis": 1}

    def train_step(step_carry, xs):
        pk, mk, vk, ek, step, nan_epoch, loss_sum = step_carry
        if pregather:
            coords, t, y, w, lrs, b = xs
        else:
            idx, lrs, b = xs
            coords, t, y, w = _dp_shard(spec, mesh, data.tr_coords[idx],
                                        data.tr_t[idx], data.tr_y[idx],
                                        data.tr_w[idx])
        rng = jax.random.fold_in(drop_key, b)

        loss, gk = jax.value_and_grad(
            lambda q: training_loss(spec, ps.unpack(q), consts, coords, t, y,
                                    w, train=True, rng=rng))(pk)
        if damping_on:
            # same formula as the unpacked path: damp the centers slice of
            # the packed basis group via the shared optimizer helper
            from st_dadk_tpu.train.optimizer import gradient_damping
            g_centers = gradient_damping(
                gk["basis"][: 2 * k].reshape(k, 2),
                pk["basis"][: 2 * k].reshape(k, 2),
                consts["spatial_centers_init"],
                spec.damping_threshold, spec.damping_strength)
            gk = dict(gk, basis=jnp.concatenate(
                [g_centers.reshape(-1), gk["basis"][2 * k:]]))
        if spec.grad_clip > 0:
            clipped = {g: packed_clip(
                gk[g], spec.grad_clip * (0.1 if g == "basis" else 1.0))
                for g in gk}
            gk = clipped

        t_new = step + 1
        tf = t_new.astype(jnp.float32)
        npk, nmk, nvk = {}, {}, {}
        for g in pk:
            npk[g], nmk[g], nvk[g] = packed_adamw(
                pk[g], gk[g], mk[g], vk[g], tf, lrs[lr_col[g]],
                spec.weight_decay)
        nek = {g: data.ema_decay * ek[g] + (1.0 - data.ema_decay) * npk[g]
               for g in ek}

        executes = jnp.logical_and(b < data.n_batches,
                                   jnp.logical_not(nan_epoch))
        w_ = lambda a, c: jnp.where(executes, a, c)
        pk = {g: w_(npk[g], pk[g]) for g in pk}
        mk = {g: w_(nmk[g], mk[g]) for g in mk}
        vk = {g: w_(nvk[g], vk[g]) for g in vk}
        ek = {g: w_(nek[g], ek[g]) for g in ek}
        step = jnp.where(executes, t_new, step)
        loss_sum = loss_sum + jnp.where(executes, loss, 0.0)
        nan_epoch = jnp.logical_or(
            nan_epoch, jnp.logical_and(executes, ~jnp.isfinite(loss)))
        return (pk, mk, vk, ek, step, nan_epoch, loss_sum), None

    step_init = (carry["pk"], carry["mk"], carry["vk"], carry["ek"],
                 carry["step"], jnp.asarray(False),
                 jnp.asarray(0.0, jnp.float32))
    (pk, mk, vk, ek, step, nan_epoch, loss_sum), _ = jax.lax.scan(
        train_step, step_init, xs_all, unroll=spec.scan_unroll)

    train_loss = loss_sum / jnp.maximum(data.n_batches.astype(jnp.float32), 1.0)
    train_loss = jnp.where(nan_epoch, jnp.nan, train_loss)

    if spec.ablate_validate:
        val_loss, val_rmse = train_loss, jnp.asarray(0.0, jnp.float32)
    else:
        val_loss, val_rmse = _validate(spec, ps.unpack(ek), consts, data,
                                       mesh=mesh)

    improved, was_stopped, scalars = _epoch_bookkeeping(
        spec, carry, val_loss, epoch_idx, active)
    bk = {g: jnp.where(improved, ek[g], carry["bk"][g]) for g in ek}
    kv = lambda a, c: jnp.where(was_stopped, c, a)
    new_carry = {
        "pk": {g: kv(pk[g], carry["pk"][g]) for g in pk},
        "mk": {g: kv(mk[g], carry["mk"][g]) for g in mk},
        "vk": {g: kv(vk[g], carry["vk"][g]) for g in vk},
        "ek": {g: kv(ek[g], carry["ek"][g]) for g in ek},
        "bk": {g: kv(bk[g], carry["bk"][g]) for g in bk},
        "step": kv(step, carry["step"]),
        **scalars,
    }
    hist = _epoch_hist(was_stopped, train_loss, val_loss, val_rmse)
    if spec.record_centers:
        hist["centers"] = new_carry["pk"]["basis"][: 2 * k].reshape(k, 2)
    return new_carry, hist


_EPOCH_SCAN_CACHE: Dict[Any, Any] = {}
_JIT_CACHE: Dict[Any, Any] = {}


def make_epoch_scan(spec: LoopSpec, mesh=None):
    """Build fit_chunk(carry, consts, data, epoch_ids, lr_chunk, active)
    scanning a block of epochs. Pure; jit/vmap-friendly.

    With a `mesh` and spec.dp_axis set, minibatches are sharded over the
    mesh's dp axis (data parallelism via sharding constraints; see
    _dp_shard). Cached by (spec, mesh): jit executables are keyed on
    function identity, so a fresh closure per call would force a full
    recompile of the whole-fit program on every batch (tens of seconds on
    the GPU against seconds to run it).

    The epoch loop is a lax.while_loop (not scan) writing history rows by
    dynamic index: a lane stops ITERATING the moment its early-stop flag is
    set, instead of burning masked no-op epochs until the chunk ends. Under
    vmap the loop runs until every lane in the batch has stopped — on the
    bench workload (stop epochs 72-118 of a 100-epoch chunk grid) that cuts
    the executed epoch count nearly in half. Unwritten history rows keep
    their NaN initialization, matching the scan's was_stopped semantics."""
    key = (spec, mesh)
    fn = _EPOCH_SCAN_CACHE.get(key)
    if fn is None:
        ps = None
        if spec.packed_opt:
            from st_dadk_tpu.train.packing import pack_spec_for_model
            ps = pack_spec_for_model(spec.model)

        def fit_chunk(carry, consts, data, epoch_ids, lr_chunk, active):
            chunk = epoch_ids.shape[0]
            if ps is not None:
                carry = _pack_carry(ps, carry)
                run_ep = lambda c, xs: _run_epoch_packed(
                    spec, ps, consts, data, c, xs, mesh=mesh)
            else:
                run_ep = lambda c, xs: _run_epoch(
                    spec, consts, data, c, xs, mesh=mesh)
            hist_avals = jax.eval_shape(
                lambda c: run_ep(
                    c, (epoch_ids[0], lr_chunk[0], active[0]))[1],
                carry)
            hist0 = jax.tree_util.tree_map(
                lambda a: jnp.full((chunk,) + a.shape, jnp.nan, a.dtype),
                hist_avals)

            def cond(state):
                c, _, it = state
                live = jnp.logical_and(it < chunk,
                                       jnp.logical_not(c["stopped"]))
                return jnp.logical_and(
                    live, active[jnp.minimum(it, chunk - 1)])

            def body(state):
                c, h, it = state
                xs = (epoch_ids[it], lr_chunk[it], active[it])
                c2, he = run_ep(c, xs)
                h2 = jax.tree_util.tree_map(
                    lambda buf, e: jax.lax.dynamic_update_index_in_dim(
                        buf, e.astype(buf.dtype), it, 0), h, he)
                return (c2, h2, it + 1)

            carry, hist, _ = jax.lax.while_loop(
                cond, body, (carry, hist0, jnp.asarray(0, jnp.int32)))
            if ps is not None:
                carry = _unpack_carry(ps, carry)
            ce = spec.centers_every
            if spec.record_centers and ce > 1 and "centers" in hist:
                assert chunk % ce == 0, \
                    "centers_every must divide the chunk length"
                hist["centers"] = hist["centers"][ce - 1::ce]
            return carry, hist
        fn = fit_chunk
        _EPOCH_SCAN_CACHE[key] = fn
    return fn


def jitted_fit_chunk(spec: LoopSpec, vmapped: bool, lr_per_lane: bool = False,
                     mesh=None, spmd_axis: Optional[str] = None):
    """Process-cached jitted (optionally vmapped) whole-fit chunk program.

    With `lr_per_lane`, the LR table carries a leading lane axis — lanes of a
    stacked batch with different real batch counts get their own warmup
    pacing (the reference paces warmup by each fit's own batches/epoch).

    With `mesh` (+ spec.dp_axis) minibatches shard over the dp axis; when
    additionally vmapped, `spmd_axis` names the mesh axis the LANE dimension
    shards over, giving the full {'exp': m, 'data': d} hybrid in one program.
    """
    key = (spec, vmapped, lr_per_lane, mesh, spmd_axis)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        base = make_epoch_scan(spec, mesh=mesh)
        if vmapped:
            lr_ax = 0 if lr_per_lane else None
            base = jax.vmap(base, in_axes=(0, 0, 0, None, lr_ax, None),
                            spmd_axis_name=spmd_axis)
        fn = jax.jit(base, donate_argnums=(0,))
        _JIT_CACHE[key] = fn
    return fn


_PREPARE_CACHE: Dict[Any, Any] = {}


def prepare_carry_batch(spec_model: ModelSpec, M: int,
                        k_pad: Optional[int] = None):
    """Cached jitted program building (carry_b, consts_b) for M lanes from
    (keys (M,), centers_b (M,k,2), bandwidths_b (M,k)) in ONE dispatch.

    Consolidating per-lane init_model + stacking into a single program
    replaces a Python loop of small per-lane eager inits, each a separate
    compile and dispatch in a fresh process.

    With `k_pad` (ragged-k stacking), `spec_model` is the lane's REAL spec:
    params draw at real shapes — identical values to the sequential engine —
    and are zero-padded to the shared program width (pad_lane_model)."""
    from st_dadk_tpu.models.st_interp import init_model, pad_lane_model

    key = (spec_model, M, k_pad)
    fn = _PREPARE_CACHE.get(key)
    if fn is not None:
        return fn

    def build(keys, centers_b, bw_b):
        def one(k, c, b):
            p, cc = init_model(k, spec_model, c, b)
            if k_pad is not None:
                p, cc = pad_lane_model(spec_model, k_pad, p, cc)
            return p, cc
        params_b, consts_b = jax.vmap(one)(keys, centers_b, bw_b)
        copy = lambda t: jax.tree_util.tree_map(lambda x: x + 0, t)
        opt_state = adamw_init(params_b)
        opt_state["step"] = jnp.zeros((M,), jnp.int32)  # per-lane step count
        carry_b = {
            "params": params_b,
            "opt_state": opt_state,
            "ema": copy(params_b),
            "best_ema": copy(params_b),
            "best_val": jnp.full((M,), jnp.inf, jnp.float32),
            "sig_best": jnp.full((M,), jnp.inf, jnp.float32),
            "has_best": jnp.zeros((M,), bool),
            "patience_ctr": jnp.zeros((M,), jnp.int32),
            "stopped": jnp.zeros((M,), bool),
            "stop_epoch": jnp.zeros((M,), jnp.int32),
            "key": keys,
        }
        return carry_b, consts_b

    fn = jax.jit(build)
    _PREPARE_CACHE[key] = fn
    return fn


_SELECT_JIT = None
_FLAT_JIT = None


def select_serving_device(carry_b: Dict[str, Any]) -> Params:
    """Per-lane serving params ON DEVICE: best-EMA when a best exists, final
    EMA otherwise (the assemble_result rule). One tiny jitted program."""
    global _SELECT_JIT
    if _SELECT_JIT is None:
        def program(carry):
            hb = carry["has_best"]

            def pick(b, e):
                m = hb.reshape((-1,) + (1,) * (b.ndim - 1))
                return jnp.where(m, b, e)

            serve = jax.tree_util.tree_map(pick, carry["best_ema"],
                                           carry["ema"])
            scal = jnp.stack([carry["best_val"],
                              carry["has_best"].astype(jnp.float32),
                              carry["stopped"].astype(jnp.float32),
                              carry["stop_epoch"].astype(jnp.float32)])
            return serve, scal
        _SELECT_JIT = jax.jit(program)
    return _SELECT_JIT(carry_b)


def pull_tree(tree_b: Params, lanes: Optional[slice] = None) -> Params:
    """Pull a batched param tree host-side as ONE flat transfer.

    Per-leaf np.asarray costs a transfer per leaf (dozens per carry);
    flattening on device first makes it a single transfer. `lanes` restricts
    the pull to a lane-row block — on a multi-process mesh each process may
    only fetch its own `process_lane_slice` rows (the rest are not
    addressable locally)."""
    from st_dadk_tpu.parallel.multihost import fetch_lane_rows

    global _FLAT_JIT
    if _FLAT_JIT is None:
        def program(tree):
            leaves = jax.tree_util.tree_leaves(tree)
            M = leaves[0].shape[0]
            return jnp.concatenate([l.reshape(M, -1) for l in leaves], axis=1)
        _FLAT_JIT = jax.jit(program)
    flat_d = _FLAT_JIT(tree_b)
    if lanes is None:
        lanes = slice(0, flat_d.shape[0])
    flat = fetch_lane_rows(flat_d, lanes)
    leaves, treedef = jax.tree_util.tree_flatten(tree_b)
    M = flat.shape[0]
    out_leaves, off = [], 0
    for l in leaves:
        n = int(np.prod(l.shape[1:])) if l.ndim > 1 else 1
        out_leaves.append(flat[:, off:off + n].reshape((M,) + tuple(l.shape[1:])))
        off += n
    return jax.tree_util.tree_unflatten(treedef, out_leaves)


def pull_serving_state(carry_b: Dict[str, Any],
                       lanes: Optional[slice] = None,
                       with_params: bool = True
                       ) -> Tuple[Optional[Params], Dict[str, np.ndarray]]:
    """Select each lane's serving params ON DEVICE and pull them as ONE flat
    buffer plus one scalar block.

    Pulling the whole carry instead costs 5x the bytes (params + both Adam
    moments + EMA + best-EMA) across dozens of per-leaf transfers. `lanes`
    restricts the fetch to one
    process's lane block on multi-process meshes (scal is (4, M): lane rows
    live on axis 1, fetched via its transpose).

    `with_params=False` pulls only the scalar block (serve is returned as
    None): when no lane writes artifacts/plots and metrics come from the
    all-device eval path, the ~11 MB/batch param transfer is pure
    overhead."""
    from st_dadk_tpu.parallel.multihost import fetch_lane_rows

    serve_d, scal_d = select_serving_device(carry_b)
    serve = pull_tree(serve_d, lanes) if with_params else None
    if lanes is None:
        scal = np.asarray(scal_d)
    elif getattr(scal_d, "is_fully_addressable", True):
        scal = np.asarray(scal_d)[:, lanes]    # single-process fast path
    else:
        scal = fetch_lane_rows(jnp.swapaxes(scal_d, 0, 1), lanes).T
    scalars = {
        "best_val": scal[0],
        "has_best": scal[1].astype(bool),
        "stopped": scal[2].astype(bool),
        "stop_epoch": scal[3].astype(np.int32),
    }
    return serve, scalars


def init_carry(params: Params, key: jax.Array) -> Dict[str, Any]:
    # distinct buffers per role — carry leaves must not alias under donation
    copy = lambda t: jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), t)
    return {
        "params": copy(params),
        "opt_state": adamw_init(params),
        "ema": copy(params),
        "best_ema": copy(params),
        "best_val": jnp.asarray(np.inf, jnp.float32),
        "sig_best": jnp.asarray(np.inf, jnp.float32),
        "has_best": jnp.asarray(False),
        "patience_ctr": jnp.asarray(0, jnp.int32),
        "stopped": jnp.asarray(False),
        "stop_epoch": jnp.asarray(0, jnp.int32),
        "key": key,
    }


# ---------------------------------------------------------------------------
# Host-side fit orchestration (single experiment)
# ---------------------------------------------------------------------------

class FitResult(NamedTuple):
    params: Params               # final model = best EMA (or final EMA)
    final_ema: Params
    history: Dict[str, np.ndarray]
    best_val: float
    n_epochs_run: int
    stopped_early: bool
    centers_history: list       # [(epoch, centers np)] every 100 epochs


def adaptive_batch_size(n_train: int, batch_size: int,
                        min_batches: int = 10) -> int:
    """Halve the batch until >= min_batches batches/epoch
    (ref train_st_interp.py:2275-2288)."""
    while n_train / batch_size < min_batches and batch_size > 1:
        batch_size //= 2
    return batch_size


def prepare_train_data(train_ps: PointSet, valid_ps: PointSet,
                       batch_size: int, val_chunk: Optional[int] = None,
                       cap_tr: Optional[int] = None,
                       cap_va: Optional[int] = None
                       ) -> Tuple[TrainData, int, int]:
    """Pad pointsets and compute lane scalars.

    Returns (TrainData, n_batches_shared, val params). val_chunk mirrors the
    reference rule min(max(16*batch, 32768), n_valid) (:2290-2293).
    """
    n_tr = train_ps.n_real
    B_lane = max(1, -(-n_tr // batch_size))
    cap_tr = cap_tr or B_lane * batch_size
    tr = pad_pointset(train_ps, cap_tr)

    n_va = max(1, valid_ps.n_real)
    vchunk = val_chunk or min(max(batch_size * 16, 32768), n_va)
    n_chunks = max(1, -(-n_va // vchunk))
    cap_va = cap_va or n_chunks * vchunk
    va = pad_pointset(valid_ps, cap_va)

    ema_decay = 1.0 - 1.0 / (10.0 * B_lane)
    # host (numpy) arrays: lanes are stacked with np.stack and shipped with
    # ONE device_put — per-leaf eager device ops are expensive on this setup
    data = TrainData(
        tr_coords=tr.coords, tr_t=tr.t, tr_y=tr.y, tr_w=tr.w,
        va_coords=va.coords, va_t=va.t, va_y=va.y, va_w=va.w,
        n_batches=np.asarray(B_lane, np.int32),
        ema_decay=np.asarray(ema_decay, np.float32),
    )
    return data, B_lane, vchunk


def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def save_fit_checkpoint(path, carry: Dict[str, Any], epochs_done: int,
                        hists: list) -> None:
    """Persist full mid-training state: params, optimizer moments, EMA,
    best-EMA snapshot, early-stop bookkeeping, PRNG key, epoch history.

    The reference can only resume at whole-experiment granularity
    (SURVEY.md section 5.3-5.4); this checkpoints the training loop itself.
    """
    import jax.random as jrandom
    state = dict(carry)
    key = state.pop("key")
    flat = _flatten_tree(state)
    flat["__key_data"] = np.asarray(jrandom.key_data(key))
    flat["__epochs_done"] = np.asarray(epochs_done)
    hist_cat = {f"__hist.{k}": np.concatenate([h[k] for h in hists])
                for k in (hists[0] if hists else {})}
    tmp = Path(str(path) + ".tmp.npz")
    np.savez(tmp, **flat, **hist_cat)
    tmp.replace(path)


def load_fit_checkpoint(path) -> Tuple[Dict[str, Any], int, list]:
    import jax.random as jrandom
    data = np.load(path, allow_pickle=False)
    flat, hist = {}, {}
    epochs_done, key = 0, None
    for name in data.files:
        if name == "__key_data":
            key = jrandom.wrap_key_data(jnp.asarray(data[name]))
        elif name == "__epochs_done":
            epochs_done = int(data[name])
        elif name.startswith("__hist."):
            hist[name[len("__hist."):]] = data[name]
        else:
            flat[name] = data[name]
    carry = _unflatten_tree(flat)
    carry["key"] = key
    hists = [hist] if hist else []
    return carry, epochs_done, hists


def fit(cfg: ExperimentConfig, spec_model: ModelSpec, params: Params,
        consts: Dict[str, Any], train_ps: PointSet, valid_ps: PointSet,
        seed: int, epochs_chunk: int = 50, verbose: bool = False,
        checkpoint_path=None, resume: bool = False,
        session_epochs: Optional[int] = None,
        mesh=None, dp_axis: str = "data") -> FitResult:
    """Train one model. Runs the jitted epoch scan in chunks so early stopping
    can exit between chunks without recompiling.

    With `checkpoint_path`, the complete loop state is written after every
    chunk and `resume=True` continues bit-exactly from the last checkpoint
    (per-epoch RNG is derived by folding the epoch index into the carried
    key, so the schedule of randomness is position-stable). A `.npz` path
    selects the single-file numpy backend; any other path is an Orbax
    checkpoint directory (train.checkpoint).

    With `mesh` (a jax.sharding.Mesh containing `dp_axis`), one large fit is
    data-parallel over all mesh devices with the COMPLETE training machinery
    (LR state machine, EMA, early stopping, NaN guard): minibatches shard
    over `dp_axis`, params stay replicated, XLA inserts the per-step gradient
    all-reduce (SURVEY.md section 2.4 row 3)."""
    batch_size = adaptive_batch_size(train_ps.n_real, cfg.batch_size)
    data, B, val_chunk = prepare_train_data(train_ps, valid_ps, batch_size)
    n_val_chunks = data.va_coords.shape[0] // val_chunk

    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B,
                                val_chunk, n_val_chunks)
    lr_mlp, lr_basis, lr_recorded = build_lr_tables(cfg, B)
    lr_steps = np.stack([lr_mlp, lr_basis], axis=-1).reshape(cfg.epochs, B, 2)

    replicate = lambda t: t
    if mesh is not None:
        from dataclasses import replace as _dc_replace

        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = _dc_replace(spec, dp_axis=dp_axis)
        rep = NamedSharding(mesh, P())
        replicate = lambda t: jax.device_put(t, rep)

    fit_chunk = jitted_fit_chunk(spec, vmapped=False, mesh=mesh)
    carry = replicate(init_carry(params, jax.random.PRNGKey(seed)))
    consts = replicate(consts)
    data = replicate(data)

    E = cfg.epochs
    chunk = min(epochs_chunk, E)
    hists = []
    epochs_done = 0
    from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                               load_checkpoint,
                                               save_checkpoint)
    if resume and checkpoint_path is not None \
            and checkpoint_exists(checkpoint_path):
        carry, epochs_done, hists = load_checkpoint(checkpoint_path)
        carry = replicate(carry)
        if verbose:
            print(f"Resumed training from epoch {epochs_done}")
    session_limit = E if session_epochs is None else \
        min(E, epochs_done + session_epochs)

    # optional device profiling (SURVEY.md section 5.1 "JAX profiler
    # optional"): set profile_dir in the config to trace the fit
    import contextlib
    stack = contextlib.ExitStack()
    if cfg.extra.get("profile_dir"):
        stack.enter_context(jax.profiler.trace(str(cfg.extra["profile_dir"])))
    while epochs_done < session_limit and not bool(np.asarray(carry["stopped"])):
        # clamp to the SESSION budget too, not just total epochs — otherwise
        # a session_epochs smaller than the chunk overshoots by up to
        # chunk-1 epochs (partial chunks are padded below, so any c works)
        c = min(chunk, E - epochs_done, session_limit - epochs_done)
        ids = jnp.arange(epochs_done, epochs_done + c, dtype=jnp.int32)
        lr_c = jnp.asarray(lr_steps[epochs_done:epochs_done + c])
        active = jnp.ones((chunk,), bool)
        if c != chunk:
            # pad the final partial chunk so the jitted shape is reused;
            # padded epochs are inactive no-ops
            pad = chunk - c
            ids = jnp.concatenate([ids, jnp.full((pad,), E - 1, jnp.int32)])
            lr_c = jnp.concatenate([lr_c, jnp.repeat(lr_c[-1:], pad, 0)])
            active = active.at[c:].set(False)
        ids, lr_c, active = replicate((ids, lr_c, active))
        carry, hist = fit_chunk(carry, consts, data, ids, lr_c, active)
        hist = jax.tree_util.tree_map(lambda x: np.asarray(x[:c]), hist)
        hists.append(hist)
        epochs_done += c
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, carry, epochs_done, hists)
        if bool(np.asarray(carry["stopped"])):
            if verbose:
                print(f"Early stopping by epoch {epochs_done}")
            break
    stack.close()

    history_concat = ({k: np.concatenate([h[k] for h in hists])
                       for k in hists[0]} if hists
                      else {k: np.zeros((0,), np.float32)
                            for k in ("train_loss", "val_loss", "val_rmse")})
    return assemble_result(spec, carry, history_concat, lr_recorded,
                           epochs_done)


def assemble_result(spec: LoopSpec, carry: Dict[str, Any],
                    history_concat: Dict[str, np.ndarray],
                    lr_recorded: np.ndarray, epochs_done: int) -> FitResult:
    """Build a FitResult from a finished carry + concatenated epoch history.

    Shared by the single-experiment host loop and the vmapped batch engine
    (which slices one lane out of the stacked carry/history first)."""
    stop_epoch = int(np.asarray(carry["stop_epoch"]))
    stopped = bool(np.asarray(carry["stopped"]))
    n_run = stop_epoch if stopped else epochs_done
    history = {k: np.asarray(v[:n_run]) for k, v in history_concat.items()
               if k != "centers"}
    history["lr"] = lr_recorded[:n_run].copy()

    centers_history = []
    if spec.record_centers and "centers" in history_concat:
        if spec.centers_every > 1:
            # rows are already sparse: row i is the state after epoch
            # (i+1)*centers_every (device-side slicing in make_epoch_scan)
            rows = np.asarray(history_concat["centers"])
            for i in range(rows.shape[0]):
                e = (i + 1) * spec.centers_every
                if e - 1 < n_run:
                    centers_history.append((e, rows[i]))
        else:
            all_centers = np.asarray(history_concat["centers"][:n_run])
            for e in range(99, n_run, 100):
                centers_history.append((e + 1, all_centers[e]))

    has_best = bool(np.asarray(carry["has_best"]))
    best = carry["best_ema"] if has_best else carry["ema"]
    return FitResult(
        params=jax.tree_util.tree_map(np.asarray, best),
        final_ema=jax.tree_util.tree_map(np.asarray, carry["ema"]),
        history=history,
        best_val=float(np.asarray(carry["best_val"])),
        n_epochs_run=n_run,
        stopped_early=stopped,
        centers_history=centers_history,
    )


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

def _predict_chunked_raw(spec_model: ModelSpec, params: Params,
                         consts: Dict[str, Any], coords: jax.Array,
                         t: jax.Array, n_chunks: int) -> jax.Array:
    C = coords.shape[0] // n_chunks
    coords = coords.reshape(n_chunks, C, 2)
    t = t.reshape(n_chunks, C, 1)

    def body(_, xs):
        ck, tk = xs
        return None, forward(spec_model, params, consts, None, ck, tk,
                             train=False)
    _, preds = jax.lax.scan(body, None, (coords, t))
    return preds.reshape(n_chunks * C, -1)


_predict_chunked = jax.jit(_predict_chunked_raw, static_argnums=(0, 5))

_VMAP_PREDICT_CACHE: Dict[Any, Any] = {}


def _pad_points(coords: np.ndarray, t: np.ndarray, chunk: int
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Zero-pad evaluation points to a chunk multiple (the one padding
    convention for both single-model and lane-batched inference; callers
    truncate the prediction back to the real n)."""
    n = coords.shape[0]
    n_pad = round_up(n, chunk)
    coords_p = np.zeros((n_pad, 2), np.float32)
    coords_p[:n] = coords
    t_p = np.zeros((n_pad, 1), np.float32)
    t_p[:n] = t.reshape(n, 1)
    return coords_p, t_p, n_pad // chunk


def predict_lanes(spec_model: ModelSpec, params_b: Params,
                  consts_b: Dict[str, Any], coords: np.ndarray,
                  t: np.ndarray, chunk: int = 32768) -> np.ndarray:
    """Batched inference for M lanes sharing the same evaluation points:
    ONE jitted vmapped program instead of M chunked predict dispatches.
    Returns (M, n, out_dim)."""
    n = coords.shape[0]
    coords_p, t_p, n_chunks = _pad_points(coords, t, chunk)

    key = (spec_model, n_chunks, chunk)
    fn = _VMAP_PREDICT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(jax.vmap(
            lambda p, c, xy, tt: _predict_chunked_raw(spec_model, p, c, xy,
                                                      tt, n_chunks),
            in_axes=(0, 0, None, None)))
        _VMAP_PREDICT_CACHE[key] = fn
    preds = fn(params_b, consts_b, jnp.asarray(coords_p), jnp.asarray(t_p))
    return np.asarray(preds[:, :n])


def predict(spec_model: ModelSpec, params: Params, consts: Dict[str, Any],
            coords: np.ndarray, t: np.ndarray,
            chunk: int = 32768) -> np.ndarray:
    """Dense batched inference; pads to a chunk multiple and truncates."""
    n = coords.shape[0]
    coords_p, t_p, n_chunks = _pad_points(coords, t, chunk)
    preds = _predict_chunked(spec_model,
                             jax.tree_util.tree_map(jnp.asarray, params),
                             consts, jnp.asarray(coords_p), jnp.asarray(t_p),
                             n_chunks)
    return np.asarray(preds[:n])
