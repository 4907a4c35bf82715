"""Flat-packed parameter groups for the training scan.

The model's param pytree has ~15 small leaves (basis centers/log-bandwidths +
per-layer Linear/LayerNorm weights + the head). Updating them leaf-by-leaf
inside the epoch scan costs ~100 tiny elementwise kernels per optimizer step
(AdamW m/v/update x 15, EMA x 15, execute-masking selects x 45, per-leaf
clip-norm partials), and a fit at this model size can be kernel-LATENCY-bound
rather than FLOP-bound. Packing each parameter GROUP into one contiguous vector turns all of
that into a handful of ops on two flat buffers:

  - group 'basis' (iff spatial_learnable): [centers.ravel(), log_bandwidths]
  - group 'mlp': every other leaf in tree-flatten order

The two groups are exactly the reference's two optimizer param groups
(differential LR lr*basis_lr_ratio and the 0.1x clip for the basis,
train_st_interp.py:470-499, :696-707), so group-scalar LR/clip/weight-decay
on the packed vectors is bit-equivalent to the per-leaf tree version
(elementwise ops are unchanged; only clip's reduction ORDER differs, within
f32 rounding). The forward unpacks via static slices + reshapes, which XLA
fuses into the consumers.

Packing lives entirely INSIDE one fit-chunk dispatch: the external carry
(checkpoints, serving-state pulls, the batch engine's stacked carries) keeps
the structured tree layout.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]

_PACK_SPEC_CACHE: Dict[Any, Any] = {}


class PackSpec:
    """Leaf layout of a params-shaped tree split into 'basis'/'mlp' groups."""

    def __init__(self, treedef, shapes, groups):
        self.treedef = treedef
        self.shapes = tuple(tuple(s) for s in shapes)
        self.groups = tuple(groups)            # 'basis' | 'mlp' per leaf
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        offsets = {"basis": 0, "mlp": 0}
        self.offsets = []
        for g, n in zip(self.groups, self.sizes):
            self.offsets.append(offsets[g])
            offsets[g] += n
        self.group_sizes = dict(offsets)
        self.has_basis = self.group_sizes.get("basis", 0) > 0

    def pack(self, tree: Params) -> Dict[str, jax.Array]:
        """Tree -> {'basis': (nb,), 'mlp': (nm,)} flat f32 vectors.

        Works on a single tree or under vmap (leaves with a leading lane axis
        pack to (M, n) matrices: reshape keeps the lane axis leading).
        """
        leaves = jax.tree_util.tree_flatten(tree)[0]
        by_group: Dict[str, list] = {"basis": [], "mlp": []}
        for leaf, g, shape in zip(leaves, self.groups, self.shapes):
            lead = leaf.shape[: leaf.ndim - len(shape)]
            by_group[g].append(jnp.reshape(leaf, lead + (-1,)))
        out = {}
        for g, parts in by_group.items():
            if parts:
                out[g] = jnp.concatenate(parts, axis=-1)
        return out

    def unpack(self, packed: Dict[str, jax.Array]) -> Params:
        """Inverse of pack; static slices, fused into consumers by XLA."""
        leaves = []
        for g, off, n, shape in zip(self.groups, self.offsets, self.sizes,
                                    self.shapes):
            vec = packed[g]
            lead = vec.shape[:-1]
            leaves.append(jnp.reshape(vec[..., off:off + n], lead + shape))
        return jax.tree_util.tree_unflatten(self.treedef, leaves)

    def basis_slice(self, packed: Dict[str, jax.Array], name_offset: int,
                    n: int, shape: Tuple[int, ...]) -> jax.Array:
        vec = packed["basis"]
        return jnp.reshape(vec[..., name_offset:name_offset + n],
                           vec.shape[:-1] + shape)


def pack_spec_for(params_example: Params) -> PackSpec:
    """PackSpec from an example params tree (shapes only; works with
    jax.eval_shape output). The group of a leaf is 'basis' iff its path goes
    through the top-level 'basis' key — identical to optimizer.lr_tree_for."""
    leaves_p, treedef = jax.tree_util.tree_flatten_with_path(params_example)
    shapes, groups = [], []
    for path, leaf in leaves_p:
        shapes.append(tuple(leaf.shape))
        is_basis = any(getattr(k, "key", None) == "basis" for k in path)
        groups.append("basis" if is_basis else "mlp")
    return PackSpec(jax.tree_util.tree_structure(params_example),
                    shapes, groups)


def pack_spec_for_model(spec_model) -> PackSpec:
    """Cached PackSpec derived from the ModelSpec alone (the params tree
    structure is a pure function of the architecture)."""
    ps = _PACK_SPEC_CACHE.get(spec_model)
    if ps is None:
        from st_dadk_tpu.models.st_interp import init_model
        params, _ = jax.eval_shape(
            lambda k: init_model(k, spec_model),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        ps = pack_spec_for(params)
        _PACK_SPEC_CACHE[spec_model] = ps
    return ps


# ---------------------------------------------------------------------------
# Packed optimizer math (group-scalar LR/clip; see st_dadk_tpu.train.optimizer
# for the per-leaf reference versions these mirror)
# ---------------------------------------------------------------------------

def packed_clip(g: jax.Array, max_norm: float) -> jax.Array:
    """clip_by_global_norm on one packed group vector."""
    total = jnp.sqrt(jnp.sum(g.astype(jnp.float32) ** 2))
    return g * jnp.minimum(1.0, max_norm / (total + 1e-6))


def packed_adamw(p: jax.Array, g: jax.Array, m: jax.Array, v: jax.Array,
                 t: jax.Array, lr: jax.Array, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One AdamW step on a packed group (torch semantics; bias-corrected).
    `t` is the ALREADY-incremented step count."""
    new_m = b1 * m + (1 - b1) * g
    new_v = b2 * v + (1 - b2) * g * g
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    new_p = p * (1.0 - lr * weight_decay) - lr * (new_m / bc1) / (
        jnp.sqrt(new_v / bc2) + eps)
    return new_p, new_m, new_v
