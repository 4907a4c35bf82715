"""Data-parallel training step (shard_map + pmean over the cards of a host).

The reference has no gradient-sync parallelism (its models are tiny; SURVEY.md
section 2.4 row 3) — this is the natural free capability on a multi-GPU host
for large single fits: the minibatch is sharded over the 'data' mesh axis, each
device computes gradients on its shard, and gradients/losses are pmean-ed
(DDP-style per-replica-mean semantics). Parameters, optimizer state, and EMA
stay replicated, so the update is identical on every replica.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from st_dadk_tpu.train.loop import LoopSpec, training_loss, _transform_grads
from st_dadk_tpu.train.optimizer import adamw_update, ema_update, lr_tree_for

Params = Dict[str, Any]


def make_dp_train_step(spec: LoopSpec, mesh: Mesh, axis: str = "data"):
    """Build a jitted data-parallel train step.

    step(params, opt_state, ema, consts, batch, lrs) -> (params, opt_state,
    ema, loss) where batch = (coords, t, y, w, rng_seed) with leading point
    axis sharded over `axis`.
    """

    n_dev = mesh.shape[axis]

    def _step(params, opt_state, ema, consts, coords, t, y, w, lrs,
              ema_decay, rng):
        # Weighted-mean correctness under uneven padding: training_loss
        # returns the LOCAL weighted mean, and pmean of per-shard weighted
        # means != the global weighted mean when padding (w=0 rows)
        # concentrates in one shard (e.g. the ragged tail of a batch).
        # Scaling each shard's loss by its weight share (wsum_s * n / W)
        # makes pmean reproduce sum_s(wsum_s * mean_s) / W — the exact
        # global weighted mean the unsharded loop computes. The replicated
        # penalty terms inside training_loss come through exactly too:
        # their share coefficients sum to 1 across shards.
        wsum = jnp.maximum(jnp.sum(w), 1e-12)
        share = wsum * n_dev / jax.lax.psum(wsum, axis)

        # per-shard dropout decorrelation: the replicated rng would give
        # every shard the SAME (n_local, sum(hidden)) mask tensor, i.e.
        # example i of every shard shares one mask — n_dev x fewer
        # independent masks than the unsharded loop draws over the global
        # batch. Folding in the shard index keeps masks independent (the
        # stream differs from unsharded, like every other mask-source
        # implementation detail; distribution is identical).
        rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))

        def loss_fn(p):
            return share * training_loss(spec, p, consts, coords, t, y, w,
                                         train=True, rng=rng)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        # DDP-style gradient sync: mean over replicas (of share-scaled
        # locals = the exact global objective)
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        grads = _transform_grads(spec, grads, params, consts)
        lr_tree = lr_tree_for(params, lrs[0], lrs[1])
        params, opt_state = adamw_update(params, grads, opt_state, lr_tree,
                                         spec.weight_decay)
        ema = ema_update(ema, params, ema_decay)
        return params, opt_state, ema, loss

    rep = P()
    sharded = P(axis)
    mapped = shard_map(
        _step, mesh=mesh,
        in_specs=(rep, rep, rep, rep, sharded, sharded, sharded, sharded,
                  rep, rep, rep),
        out_specs=(rep, rep, rep, rep),
        check_rep=False,
    )
    return jax.jit(mapped)
