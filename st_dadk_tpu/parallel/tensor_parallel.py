"""Tensor parallelism over the basis dimension (shard_map + psum).

For large-N fits with many basis centers (the 3a/3b-scale regime), the (N, k) basis matrix and the k x h first MLP layer
dominate memory and FLOPs. Sharding the center dimension k over a 'tp' mesh
axis makes both the basis construction and the first matmul local:

    device d holds  centers_d, bandwidths_d, W1_spatial_d  (k/n_dev rows)
    partial_d = phi(coords; centers_d) @ W1_spatial_d       (N, h)
    h1 = psum_d(partial_d + replicated_terms / n_dev)       exact first layer

The remaining MLP layers are small and run replicated. The reference has no
equivalent (single-process torch; SURVEY.md section 2.4); this is the natural
multi-card scaling path for the basis axis. Exactness vs the unsharded forward is
tested on the virtual 8-device CPU mesh (tests/test_tensor_parallel.py).

TP params use an explicit layout that separates the first layer into
sharded-spatial and replicated-temporal blocks (`to_tp_params`); covariates
(p > 0) are not supported on this path — the reference's workloads all use
p = 0.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from st_dadk_tpu.models.st_interp import ModelSpec, head
from st_dadk_tpu.ops.basis import spatial_basis_embed, temporal_basis_embed

Params = Dict[str, Any]


def to_tp_params(spec: ModelSpec, params: Params, consts: Dict[str, Any],
                 n_dev: int) -> Tuple[Params, Dict[str, Any]]:
    """Convert a standard param tree to the TP layout, padding the center
    dimension to a multiple of n_dev. Padded centers sit at 0.5 (inside the
    domain, so center penalties see zero violation) with ZERO weight rows —
    the zero rows guarantee the pads contribute nothing to the FORWARD.
    They do NOT guarantee zero gradient (phi at the pad centers is nonzero,
    so dL/dW0 pad rows are nonzero); `make_tp_train_step` masks the pad-row
    gradients and pins the pad rows to keep them inert under training."""
    if spec.p != 0:
        raise NotImplementedError("TP basis sharding requires p_covariates=0")
    k, k_t = spec.k_spatial, spec.k_temporal
    k_pad = ((k + n_dev - 1) // n_dev) * n_dev
    pad = k_pad - k

    def pad_rows(x, value=0.0):
        if pad == 0:
            return jnp.asarray(x)
        shape = (pad,) + tuple(np.shape(x))[1:]
        return jnp.concatenate([jnp.asarray(x),
                                jnp.full(shape, value, jnp.asarray(x).dtype)])

    tp_consts = {
        "spatial_centers_init": pad_rows(consts["spatial_centers_init"], 0.5),
        "spatial_bandwidths_init": pad_rows(consts["spatial_bandwidths_init"], 1.0),
        "temporal_centers": jnp.asarray(consts["temporal_centers"]),
        "temporal_bandwidths": jnp.asarray(consts["temporal_bandwidths"]),
    }

    mlp = params["mlp"]
    w0 = jnp.asarray(mlp["linear_0"]["w"])          # (k + k_t, h)
    tp_mlp: Dict[str, Any] = {
        "w0_spatial": pad_rows(w0[:k]),             # (k_pad, h) -> sharded
        "w0_temporal": w0[k:k + k_t],               # (k_t, h)  -> replicated
        "b0": jnp.asarray(mlp["linear_0"]["b"]),
    }
    for name, leaf in mlp.items():
        if name == "linear_0":
            continue
        tp_mlp[name] = jax.tree_util.tree_map(jnp.asarray, leaf)

    tp_params: Params = {"mlp": tp_mlp}
    if spec.spatial_learnable:
        tp_params["basis"] = {
            "centers": pad_rows(params["basis"]["centers"], 0.5),
            "log_bandwidths": pad_rows(params["basis"]["log_bandwidths"], 0.0),
        }
    return tp_params, tp_consts


def tp_param_specs(spec: ModelSpec, axis: str = "tp") -> Params:
    mlp: Dict[str, Any] = {
        "w0_spatial": P(axis, None),
        "w0_temporal": P(),
        "b0": P(),
    }
    for i in range(1, len(spec.hidden_dims)):
        mlp[f"linear_{i}"] = {"w": P(), "b": P()}
    if spec.layernorm:
        for i in range(len(spec.hidden_dims)):
            mlp[f"ln_{i}"] = {"scale": P(), "bias": P()}
    if spec.delta_head:
        mlp["delta"] = P()
    else:
        mlp["out"] = {"w": P(), "b": P()}
    out: Params = {"mlp": mlp}
    if spec.spatial_learnable:
        out["basis"] = {"centers": P(axis, None), "log_bandwidths": P(axis)}
    return out


def tp_consts_specs(axis: str = "tp") -> Dict[str, Any]:
    return {
        "spatial_centers_init": P(axis, None),
        "spatial_bandwidths_init": P(axis),
        "temporal_centers": P(),
        "temporal_bandwidths": P(),
    }


def _ln(h, ln):
    mean = jnp.mean(h, axis=-1, keepdims=True)
    var = jnp.var(h, axis=-1, keepdims=True)
    return (h - mean) * jax.lax.rsqrt(var + 1e-5) * ln["scale"] + ln["bias"]


def make_tp_forward(spec: ModelSpec, mesh: Mesh, axis: str = "tp"):
    """Jitted forward(tp_params, tp_consts, coords, t) with the basis axis
    sharded over `axis`; coords/t replicated; output replicated."""
    n_dev = mesh.shape[axis]

    def _forward(params, consts, coords, t):
        # rng=None skips dropout: _tp_forward_train IS the inference path
        # (one copy of the TP layer stack to keep in sync)
        return _tp_forward_train(spec, params, consts, coords, t, axis,
                                 n_dev, None)

    mapped = shard_map(
        _forward, mesh=mesh,
        in_specs=(tp_param_specs(spec, axis), tp_consts_specs(axis), P(), P()),
        out_specs=P(),
        check_rep=False,
    )
    return jax.jit(mapped)


def place_tp(tree: Params, specs: Params, mesh: Mesh) -> Params:
    """device_put a TP tree according to its PartitionSpecs."""
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
        is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# Tensor-parallel TRAINING step
# ---------------------------------------------------------------------------

def _tp_forward_train(spec: ModelSpec, params: Params, consts: Dict[str, Any],
                      coords, t, axis: str, n_dev: int, rng):
    """TP forward in train mode. Dropout masks are applied to the post-psum
    (replicated) activations with the same rng on every device, so the
    computation is bitwise-equivalent to the unsharded forward."""
    mlp = params["mlp"]
    if spec.spatial_learnable:
        centers = params["basis"]["centers"]
        bandwidths = jnp.exp(params["basis"]["log_bandwidths"])
    else:
        centers = consts["spatial_centers_init"]
        bandwidths = consts["spatial_bandwidths_init"]
    phi_local = spatial_basis_embed(coords, centers, bandwidths,
                                    spec.spatial_basis_function)
    partial = phi_local @ mlp["w0_spatial"]
    psi = temporal_basis_embed(t, consts["temporal_centers"],
                               consts["temporal_bandwidths"])
    rep = psi @ mlp["w0_temporal"] + mlp["b0"]
    h = jax.lax.psum(partial + rep / n_dev, axis)

    for i in range(len(spec.hidden_dims)):
        if i > 0:
            lin = mlp[f"linear_{i}"]
            h = h @ lin["w"] + lin["b"]
        if spec.layernorm:
            h = _ln(h, mlp[f"ln_{i}"])
        h = jax.nn.relu(h)
        if spec.dropout > 0.0 and rng is not None:
            rng, sub = jax.random.split(rng)
            keep = jax.random.bernoulli(sub, 1.0 - spec.dropout, h.shape)
            h = jnp.where(keep, h / (1.0 - spec.dropout), 0.0)
    return head(spec, {"mlp": mlp}, h)


def _tp_supported_loss(regression, quantile_levels, current_quantile):
    """The mean / quantile / multi-quantile DATA losses in the TP layout.
    Penalties live in _tp_penalties (epoch path) or the explicit
    domain-penalty argument of make_tp_train_step — see those for what each
    entry point optimizes."""
    from st_dadk_tpu.ops.losses import (mse_loss, multi_quantile_loss,
                                        quantile_loss)
    if regression == "multi-quantile":
        q = jnp.asarray(quantile_levels, jnp.float32)
        return lambda preds, y, w: multi_quantile_loss(preds, y, q, w)
    if regression == "quantile":
        # current_quantile=None defaults to quantile_levels[0], matching the
        # sequential engine's substitution (train/experiment.py) — a 0.5
        # fallback would silently fit the median for e.g. levels=[0.9]
        if current_quantile is not None:
            tau = float(current_quantile)
        elif quantile_levels:
            tau = float(quantile_levels[0])
        else:
            tau = 0.5
        return lambda preds, y, w: quantile_loss(preds, y, tau, w)
    return lambda preds, y, w: mse_loss(preds, y, w)


def _tp_penalties(spec, loop_spec, p, preds, consts, w, axis, train):
    """Every composite-loss penalty of loop.loss_from_preds, on the TP
    layout (mirrors loop.py — same weights, same train/val gating):
    sharded-leaf terms (movement, spatial sparsity, domain) sum locally and
    psum (pad rows are pinned at init / exactly zero, so they contribute
    nothing); replicated-leaf terms (delta P_nc, prediction-level
    non-crossing, temporal sparsity) add directly."""
    from st_dadk_tpu.models.st_interp import sparsity_block
    from st_dadk_tpu.ops.losses import (non_crossing_penalty,
                                        p_nc_delta_penalty)

    loss = jnp.asarray(0.0, jnp.float32)
    if loop_spec.regression_type == "multi-quantile":
        if spec.use_delta_reparameterization and spec.delta_head:
            if loop_spec.non_crossing_lambda > 0:
                p_nc = p_nc_delta_penalty(p["mlp"]["delta"])
                if loop_spec.non_crossing_delta_mode == "abs":
                    p_nc = -p_nc
                loss = loss + loop_spec.non_crossing_lambda * p_nc
        elif loop_spec.non_crossing_weight > 0:
            loss = loss + loop_spec.non_crossing_weight * non_crossing_penalty(
                preds, "mean", loop_spec.non_crossing_power, weights=w)
    if train:
        if spec.spatial_learnable:
            if loop_spec.domain_penalty_weight > 0:
                c = p["basis"]["centers"]
                viol = jax.nn.relu(-c) + jax.nn.relu(c - 1.0)
                loss = loss + loop_spec.domain_penalty_weight * jax.lax.psum(
                    jnp.sum(viol ** 2), axis)
            if loop_spec.movement_penalty_weight > 0:
                move = p["basis"]["centers"] - consts["spatial_centers_init"]
                loss = loss + loop_spec.movement_penalty_weight * \
                    jax.lax.psum(jnp.sum(move ** 2), axis)
        if loop_spec.sparsity_penalty_type != "none":
            pt = loop_spec.sparsity_penalty_type
            l1, lg = loop_spec.sparsity_lambda_l1, loop_spec.sparsity_lambda_group
            if loop_spec.sparsity_apply_to_spatial:
                loss = loss + jax.lax.psum(
                    sparsity_block(p["mlp"]["w0_spatial"], pt, l1, lg), axis)
            if loop_spec.sparsity_apply_to_temporal:
                loss = loss + sparsity_block(p["mlp"]["w0_temporal"], pt,
                                             l1, lg)
    return loss


def make_tp_train_step(spec: ModelSpec, mesh: Mesh, axis: str = "tp",
                       regression: str = "mean",
                       quantile_levels=None,
                       domain_penalty_weight: float = 0.0,
                       weight_decay: float = 0.0):
    """Jitted tensor-parallel train step: the batch is REPLICATED, the basis
    axis (centers, bandwidths, first-layer spatial rows) is SHARDED.

    Objective = data loss + (optional) domain penalty ONLY — by signature:
    there is no way to request sparsity/movement/non-crossing penalties
    here. Configs carrying those belong on `fit_tp`/`make_tp_epoch`, whose
    _tp_penalties implements the full composite loss in the TP layout.

    Gradients of sharded leaves are purely local (their only cross-device
    dependency is the activation psum, whose backward is handled by
    shard_map autodiff); gradients of replicated leaves come out identical
    on every device, so a plain AdamW update keeps the layout consistent.

    step(tp_params, opt_state, consts, coords, t, y, w, lrs, rng)
      -> (tp_params, opt_state, loss)
    """
    from st_dadk_tpu.train.optimizer import adamw_update, lr_tree_for

    n_dev = mesh.shape[axis]
    data_loss_fn = _tp_supported_loss(regression, quantile_levels,
                                      quantile_levels[0]
                                      if regression == "quantile"
                                      and quantile_levels else None)

    def _step(params, opt_state, consts, coords, t, y, w, lrs, rng):
        def loss_fn(p):
            preds = _tp_forward_train(spec, p, consts, coords, t, axis,
                                      n_dev, rng)
            loss = data_loss_fn(preds, y, w)
            if spec.spatial_learnable and domain_penalty_weight > 0:
                c = p["basis"]["centers"]
                viol = jax.nn.relu(-c) + jax.nn.relu(c - 1.0)
                loss = loss + domain_penalty_weight * jax.lax.psum(
                    jnp.sum(viol ** 2), axis)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)

        # Pad rows (global row >= k_spatial, on the last shard) must stay
        # inert. phi at the pad centers is NONZERO over the whole domain, so
        # the zero w0_spatial pad rows still receive gradient (dL/dW0 =
        # phi^T dL/dh); left unmasked, AdamW drives them off zero and the
        # pads become phantom basis functions. Mask sharded-leaf grads with
        # a static row-validity mask, then pin the pad rows of params after
        # the update (decoupled weight decay would otherwise shrink the pad
        # centers even under zero gradient).
        k_loc = grads["mlp"]["w0_spatial"].shape[0]
        rows = jax.lax.axis_index(axis) * k_loc + jnp.arange(k_loc)
        valid = rows < spec.k_spatial

        def mask_rows(g):
            m = valid.reshape((-1,) + (1,) * (g.ndim - 1))
            return g * m.astype(g.dtype)

        grads["mlp"]["w0_spatial"] = mask_rows(grads["mlp"]["w0_spatial"])
        if spec.spatial_learnable:
            grads["basis"] = jax.tree_util.tree_map(mask_rows, grads["basis"])

        lr_tree = lr_tree_for(params, lrs[0], lrs[1])
        prev = params
        params, opt_state = adamw_update(params, grads, opt_state, lr_tree,
                                         weight_decay)

        def pin(new, old):
            m = valid.reshape((-1,) + (1,) * (new.ndim - 1))
            return jnp.where(m, new, old)

        params["mlp"]["w0_spatial"] = pin(params["mlp"]["w0_spatial"],
                                          prev["mlp"]["w0_spatial"])
        if spec.spatial_learnable:
            params["basis"] = jax.tree_util.tree_map(
                pin, params["basis"], prev["basis"])
        return params, opt_state, loss

    p_specs = tp_param_specs(spec, axis)
    c_specs = tp_consts_specs(axis)
    rep = P()
    mapped = shard_map(
        _step, mesh=mesh,
        in_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": rep},
                  c_specs, rep, rep, rep, rep, rep, rep),
        out_specs=(p_specs, {"m": p_specs, "v": p_specs, "step": rep}, rep),
        check_rep=False,
    )
    return jax.jit(mapped)


# ---------------------------------------------------------------------------
# Full tensor-parallel TRAINING LOOP
# ---------------------------------------------------------------------------

_TP_EPOCH_CACHE: Dict[Any, Any] = {}


def make_tp_epoch(spec: ModelSpec, mesh: Mesh, loop_spec, axis: str = "tp"):
    """Jitted TP epoch program: minibatch scan (grad masking + AdamW + EMA)
    followed by EMA-swap validation — the full train.loop machinery in the
    TP layout (basis rows sharded, batch replicated).

    epoch(carry, data, lr_epoch, epoch_idx) -> (carry, (train_loss, val_loss,
    val_rmse)); carry mirrors train.loop's (params/opt/ema/best_ema/
    best_val/has_best/patience/stopped/key).
    """
    from st_dadk_tpu.train.loop import epoch_batch_indices
    from st_dadk_tpu.train.optimizer import (adamw_update, ema_update,
                                             lr_tree_for)

    key_c = (spec, mesh, loop_spec, axis)
    fn = _TP_EPOCH_CACHE.get(key_c)
    if fn is not None:
        return fn

    n_dev = mesh.shape[axis]
    data_loss_fn = _tp_supported_loss(loop_spec.regression_type,
                                      loop_spec.quantile_levels,
                                      getattr(loop_spec, "current_quantile",
                                              None))
    bs, B = loop_spec.batch_size, loop_spec.n_batches

    def data_loss(p, consts, coords, t, y, w, rng):
        preds = _tp_forward_train(spec, p, consts, coords, t, axis, n_dev,
                                  rng)
        loss = data_loss_fn(preds, y, w)
        return loss + _tp_penalties(spec, loop_spec, p, preds, consts, w,
                                    axis, train=True)

    def _epoch(carry, data, lr_epoch, epoch_idx):
        params, opt, ema, best_ema, best_val, has_best, pat, stopped, key \
            = carry
        consts, tr, va = data
        ekey = jax.random.fold_in(key, epoch_idx)
        perm_key, drop_key = jax.random.split(ekey)
        cap = tr["coords"].shape[0]
        # same shuffle source as the replicated loop (spec.shuffle='auto'
        # selects the sort-free hash permutation on pow2 caps) so fit_tp
        # walks the same batch sequence as fit for the same key chain
        batch_idx = epoch_batch_indices(perm_key, cap, bs, B,
                                        jnp.asarray(B, jnp.int32),
                                        uniform=True,
                                        shuffle=loop_spec.shuffle)

        k_loc = params["mlp"]["w0_spatial"].shape[0]
        rows = jax.lax.axis_index(axis) * k_loc + jnp.arange(k_loc)
        valid_rows = rows < spec.k_spatial

        def mask_rows(g):
            m = valid_rows.reshape((-1,) + (1,) * (g.ndim - 1))
            return g * m.astype(g.dtype)

        def pin(new, old):
            m = valid_rows.reshape((-1,) + (1,) * (new.ndim - 1))
            return jnp.where(m, new, old)

        def clip_group(tree, max_norm, sharded: set):
            # global-norm clip with the sharded leaves' sq-sums psum'd
            # across the tp axis (a local norm would under-count them)
            total = jnp.asarray(0.0, jnp.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                sq = jnp.sum(leaf.astype(jnp.float32) ** 2)
                name = jax.tree_util.keystr(path)
                if any(s in name for s in sharded):
                    sq = jax.lax.psum(sq, axis)
                total = total + sq
            scale = jnp.minimum(1.0, max_norm / (jnp.sqrt(total) + 1e-6))
            return jax.tree_util.tree_map(lambda l: l * scale, tree)

        def step(sc, xs):
            p, o, e, nan_ep, loss_sum = sc
            idx, lrs, b = xs
            rng = jax.random.fold_in(drop_key, b)
            loss, grads = jax.value_and_grad(data_loss)(
                p, consts, tr["coords"][idx], tr["t"][idx], tr["y"][idx],
                tr["w"][idx], rng)
            grads["mlp"]["w0_spatial"] = mask_rows(grads["mlp"]["w0_spatial"])
            if spec.spatial_learnable:
                grads["basis"] = jax.tree_util.tree_map(mask_rows,
                                                        grads["basis"])
                if loop_spec.gradient_damping:
                    from st_dadk_tpu.train.optimizer import gradient_damping
                    grads["basis"]["centers"] = gradient_damping(
                        grads["basis"]["centers"], p["basis"]["centers"],
                        consts["spatial_centers_init"],
                        loop_spec.damping_threshold,
                        loop_spec.damping_strength)
            if loop_spec.grad_clip > 0:
                if spec.spatial_learnable:
                    grads["basis"] = clip_group(
                        grads["basis"], loop_spec.grad_clip * 0.1,
                        {"centers", "log_bandwidths"})
                grads["mlp"] = clip_group(grads["mlp"], loop_spec.grad_clip,
                                          {"w0_spatial"})
            prev = p
            p_new, o_new = adamw_update(p, grads, o,
                                        lr_tree_for(p, lrs[0], lrs[1]),
                                        loop_spec.weight_decay)
            p_new["mlp"]["w0_spatial"] = pin(p_new["mlp"]["w0_spatial"],
                                             prev["mlp"]["w0_spatial"])
            if spec.spatial_learnable:
                p_new["basis"] = jax.tree_util.tree_map(pin, p_new["basis"],
                                                        prev["basis"])
            e_new = ema_update(e, p_new, jnp.asarray(1.0 - 1.0 / (10.0 * B)))
            # same NaN-poison gate as the replicated loop (train/loop.py
            # _run_epoch, ref :693-733): the first non-finite loss's update
            # applies (reference steps the optimizer before checking), every
            # later batch of the epoch is skipped
            executes = jnp.logical_not(nan_ep)
            sel = lambda new, old: jax.tree_util.tree_map(
                lambda a, c: jnp.where(executes, a, c), new, old)
            p = sel(p_new, p)
            o = sel(o_new, o)
            e = sel(e_new, e)
            loss_sum = loss_sum + jnp.where(executes, loss, 0.0)
            nan_ep = jnp.logical_or(
                nan_ep, jnp.logical_and(executes, ~jnp.isfinite(loss)))
            return (p, o, e, nan_ep, loss_sum), None

        (p2, o2, e2, nan_epoch, loss_sum), _ = jax.lax.scan(
            step, (params, opt, ema, jnp.asarray(False),
                   jnp.asarray(0.0, jnp.float32)),
            (batch_idx, lr_epoch, jnp.arange(B, dtype=jnp.int32)))
        train_loss = jnp.where(nan_epoch, jnp.nan, loss_sum / B)

        vp = _tp_forward_train(spec, e2, consts, va["coords"], va["t"],
                               axis, n_dev, None)
        med = (len(loop_spec.quantile_levels) // 2
               if loop_spec.regression_type == "multi-quantile" else 0)
        vw = va["w"]
        cnt = jnp.maximum(jnp.sum(vw), 1.0)
        val_loss = data_loss_fn(vp, va["y"], vw) + _tp_penalties(
            spec, loop_spec, e2, vp, consts, vw, axis, train=False)
        se = jnp.sum((vp[:, med:med + 1] - va["y"]) ** 2 * vw[:, None])
        val_rmse = jnp.sqrt(se / cnt)

        improved = jnp.logical_and(jnp.isfinite(val_loss),
                                   val_loss < best_val)
        best_ema2 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(improved, a, b), e2, best_ema)
        best_val2 = jnp.where(improved, val_loss, best_val)
        has_best2 = jnp.logical_or(has_best, improved)
        pat2 = jnp.where(improved, 0, pat + 1)
        stopped2 = jnp.logical_or(stopped, pat2 >= loop_spec.patience)

        keep = lambda new, old: jax.tree_util.tree_map(
            lambda a, b: jnp.where(stopped, b, a), new, old)
        carry2 = (keep(p2, params), keep(o2, opt), keep(e2, ema),
                  keep(best_ema2, best_ema),
                  jnp.where(stopped, best_val, best_val2),
                  jnp.where(stopped, has_best, has_best2),
                  jnp.where(stopped, pat, pat2), stopped2, key)
        return carry2, (train_loss, val_loss, val_rmse)

    p_specs = tp_param_specs(spec, axis)
    c_specs = tp_consts_specs(axis)
    rep = P()
    carry_specs = (p_specs, {"m": p_specs, "v": p_specs, "step": rep},
                   p_specs, p_specs, rep, rep, rep, rep, rep)
    data_specs = (c_specs, {"coords": rep, "t": rep, "y": rep, "w": rep},
                  {"coords": rep, "t": rep, "y": rep, "w": rep})
    mapped = shard_map(_epoch, mesh=mesh,
                       in_specs=(carry_specs, data_specs, rep, rep),
                       out_specs=(carry_specs, (rep, rep, rep)),
                       check_rep=False)
    fn = jax.jit(mapped)
    _TP_EPOCH_CACHE[key_c] = fn
    return fn


def fit_tp(cfg, spec_model: ModelSpec, params: Params,
           consts: Dict[str, Any], train_ps, valid_ps, mesh: Mesh,
           seed: int, axis: str = "tp", verbose: bool = False):
    """Full tensor-parallel training: the complete LR-table/EMA/early-stop
    machinery with the basis axis sharded over `mesh[axis]`. Returns a
    train.loop.FitResult whose params are UNSHARDED (pads stripped, first
    layer reassembled) so downstream eval/artifacts are layout-agnostic."""
    from st_dadk_tpu.dataio.arrays import pad_pointset
    from st_dadk_tpu.train.loop import FitResult, LoopSpec, adaptive_batch_size
    from st_dadk_tpu.train.optimizer import adamw_init, build_lr_tables

    if getattr(cfg, "early_stop_min_rel_delta", 0.0):
        # the TP epoch body keeps its own tuple carry without the sig
        # anchor; silently ignoring the knob would diverge from the vmap/DP
        # engines' stop semantics
        raise NotImplementedError(
            "early_stop_min_rel_delta (plateau-slope stop) is not "
            "implemented for the tensor-parallel fit; use the vmap/DP "
            "engines or set it to 0")
    n_dev = mesh.shape[axis]
    batch_size = adaptive_batch_size(train_ps.n_real, cfg.batch_size)
    B = max(1, -(-train_ps.n_real // batch_size))
    tr = pad_pointset(train_ps, B * batch_size)
    va = pad_pointset(valid_ps, max(1, valid_ps.n_real))
    loop_spec = LoopSpec.from_config(cfg, spec_model, batch_size, B,
                                     va.coords.shape[0], 1)

    tp_params, tp_consts = to_tp_params(spec_model, params, consts, n_dev)
    tp_params = place_tp(tp_params, tp_param_specs(spec_model, axis), mesh)
    tp_consts = place_tp(tp_consts, tp_consts_specs(axis), mesh)
    opt = adamw_init(tp_params)
    rep = NamedSharding(mesh, P())
    dev = lambda d: jax.device_put(
        {"coords": jnp.asarray(d.coords), "t": jnp.asarray(d.t),
         "y": jnp.asarray(d.y), "w": jnp.asarray(d.w)}, rep)
    data = (tp_consts, dev(tr), dev(va))

    lr_mlp, lr_basis, lr_recorded = build_lr_tables(cfg, B)
    lr_steps = np.stack([lr_mlp, lr_basis], -1).reshape(cfg.epochs, B, 2)

    epoch_fn = make_tp_epoch(spec_model, mesh, loop_spec, axis)
    carry = (tp_params, opt, tp_params, tp_params,
             jax.device_put(jnp.asarray(jnp.inf), rep),
             jax.device_put(jnp.asarray(False), rep),
             jax.device_put(jnp.asarray(0, jnp.int32), rep),
             jax.device_put(jnp.asarray(False), rep),
             jax.device_put(jax.random.PRNGKey(seed), rep))

    hist = {"train_loss": [], "val_loss": [], "val_rmse": []}
    n_run = 0
    for e in range(cfg.epochs):
        carry, (tl, vl, vr) = epoch_fn(
            carry, data, jax.device_put(jnp.asarray(lr_steps[e]), rep),
            jnp.asarray(e, jnp.int32))
        n_run += 1
        hist["train_loss"].append(float(tl))
        hist["val_loss"].append(float(vl))
        hist["val_rmse"].append(float(vr))
        if bool(np.asarray(carry[7])):
            if verbose:
                print(f"[fit_tp] early stop at epoch {n_run}")
            break

    has_best = bool(np.asarray(carry[5]))
    serve_tp = carry[3] if has_best else carry[2]
    serve = from_tp_params(spec_model, jax.tree_util.tree_map(np.asarray,
                                                              serve_tp))
    final = from_tp_params(spec_model, jax.tree_util.tree_map(np.asarray,
                                                              carry[2]))
    history = {k: np.asarray(v) for k, v in hist.items()}
    history["lr"] = lr_recorded[:n_run].copy()
    return FitResult(params=serve, final_ema=final, history=history,
                     best_val=float(np.asarray(carry[4])),
                     n_epochs_run=n_run,
                     stopped_early=bool(np.asarray(carry[7])),
                     centers_history=[])


def from_tp_params(spec: ModelSpec, tp_params: Params) -> Params:
    """Invert to_tp_params: strip pad rows, reassemble the first layer."""
    k, k_t = spec.k_spatial, spec.k_temporal
    mlp_tp = tp_params["mlp"]
    w0 = np.concatenate([np.asarray(mlp_tp["w0_spatial"])[:k],
                         np.asarray(mlp_tp["w0_temporal"])], axis=0)
    mlp = {"linear_0": {"w": w0, "b": np.asarray(mlp_tp["b0"])}}
    for name, leaf in mlp_tp.items():
        if name in ("w0_spatial", "w0_temporal", "b0"):
            continue
        mlp[name] = jax.tree_util.tree_map(np.asarray, leaf)
    out: Params = {"mlp": mlp}
    if spec.spatial_learnable:
        out["basis"] = {
            "centers": np.asarray(tp_params["basis"]["centers"])[:k],
            "log_bandwidths":
                np.asarray(tp_params["basis"]["log_bandwidths"])[:k],
        }
    return out
