"""Data-adaptive basis-center initializers.

The reference initializes centers with sklearn GaussianMixture (spherical,
k-means++ starts, n_init=3, max_iter=100) or size-constrained KMeans from the
`k_means_constrained` package, both CPU-sequential per experiment
(stnf/models/st_interp.py:187-431). Here the same four schemes are
reimplemented in JAX so they are jittable and vmappable across an experiment
batch — initialization for hundreds of fits runs as one device program:

  - 'uniform'        : regular grids (st_dadk_tpu.ops.basis)
  - 'gmm'            : spherical-covariance EM with k-means++ init, n_init
                       restarts, best-log-likelihood selection; bandwidth =
                       4.23 * 2.5 * sigma clipped below at 0.25x the uniform
                       bandwidth (ref st_interp.py:226-266)
  - 'random_site'    : k sampled training coords; bandwidth = 2.5 x mean
                       distance to the 4 nearest sampled neighbors
                       (ref st_interp.py:268-338)
  - 'kmeans_balanced': balanced k-means. The reference uses the exact
                       min-cost-flow solver of k_means_constrained; here
                       Lloyd iterations use a capacity-penalized assignment
                       (documented divergence — same statistical role: equal-
                       coverage density-adaptive centers). Bandwidth = 2.5 x
                       mean distance to 4 nearest centers (ref :340-431).

All functions subsample to 10k points like the reference (st_interp.py:205-213,
:367-375).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from st_dadk_tpu.ops.basis import uniform_bandwidth_for, uniform_grid_centers

MAX_INIT_SAMPLES = 10_000

# init methods that consume training coordinates (callers gate whether to
# pass train_coords on membership here — single point to extend when a new
# data-adaptive method is added)
DATA_ADAPTIVE_INIT_METHODS = ("gmm", "random_site", "kmeans_balanced",
                              "kmeans_exact")


# ---------------------------------------------------------------------------
# k-means++ seeding (jittable)
# ---------------------------------------------------------------------------

def kmeans_plus_plus(key: jax.Array, X: jax.Array, k: int,
                     w: Optional[jax.Array] = None,
                     k_active: Optional[jax.Array] = None,
                     unroll: int = 8) -> jax.Array:
    """k-means++ seeding over X (n, d) -> (k, d).

    Optional nonnegative point weights `w` (zero-weight rows are padding and
    are never selected); w=None compiles the exact unweighted program.

    `k_active` (traced scalar <= k) seeds only the first k_active centers —
    steps beyond it are masked no-ops, so resolutions with different true k
    share ONE padded program (the key chain advances identically through the
    real steps, making the active prefix match the unpadded program's draws).
    Rows [k_active:] of the result are junk the caller must mask.

    `unroll` feeds lax.scan's unroll factor: the body is tiny (one (n,)
    distance update), so at k=227 the while-loop's per-iteration dispatch
    overhead dominates; unrolling packs several exact steps per loop
    iteration without changing any draw (same key chain, same numerics)."""
    n = X.shape[0]
    if k_active is None:
        k_active = jnp.asarray(k, jnp.int32)

    def body(carry, step):
        key, centers, d2 = carry
        key, sub = jax.random.split(key)
        scores = d2 if w is None else d2 * w
        probs = scores / jnp.maximum(scores.sum(), 1e-12)
        idx = jax.random.choice(sub, n, p=probs)
        c_new = X[idx]
        upd = step < k_active - 1
        d2_new = jnp.minimum(d2, jnp.sum((X - c_new) ** 2, axis=1))
        centers_new = jnp.roll(centers, -1, axis=0).at[-1].set(c_new)
        centers = jnp.where(upd, centers_new, centers)
        d2 = jnp.where(upd, d2_new, d2)
        return (key, centers, d2), None

    key, sub = jax.random.split(key)
    # Both arms draw via choice(p=...)'s inverse-CDF so the weighted program
    # with 0/1 padding weights makes the SAME draws as the unweighted one on
    # the real prefix (appended zero-prob rows leave every real cumsum value
    # and the total bit-identical) — a lane stacked into an unequal-size
    # padded batch seeds exactly like its own standalone fit.
    if w is None:
        ones = jnp.ones((n,), X.dtype)
        first = X[jax.random.choice(sub, n, p=ones / ones.sum())]
    else:
        first = X[jax.random.choice(sub, n, p=w / jnp.maximum(w.sum(), 1e-12))]
    centers0 = jnp.tile(first[None], (k, 1))
    d2_0 = jnp.sum((X - first) ** 2, axis=1)
    (key, centers, _), _ = jax.lax.scan(
        body, (key, centers0, d2_0),
        jnp.arange(k - 1, dtype=jnp.int32), length=k - 1,
        unroll=min(unroll, max(k - 1, 1)))
    # the k_active seeded centers sit in the LAST rows after the rolls; move
    # them to the front (identity when k_active == k)
    return jnp.roll(centers, k_active, axis=0)


def kmeans_plus_plus_rounds(key: jax.Array, X: jax.Array, k: int,
                            rounds: int = 8,
                            w: Optional[jax.Array] = None,
                            k_active: Optional[jax.Array] = None
                            ) -> jax.Array:
    """Low-depth k-means++ variant: (k, d) seeds in `rounds` rounds.

    The exact seeding (`kmeans_plus_plus`) is a k-1-step sequential chain —
    each draw conditions on all previous ones — which costs ~k scan
    iterations of latency on an accelerator regardless of how small the
    per-step work is.
    Here the k-1 follow-up centers are drawn in `rounds` batches: within a
    round, candidates are drawn i.i.d. from the CURRENT d2-weighted
    distribution (k-means||-style oversampling, Bahmani et al. 2012), and d2
    is updated once per round. Sequential depth drops from k-1 to `rounds`.

    This is a documented approximation, NOT the reference's seeding: within
    a round, draws don't see each other, so near-duplicate seeds are
    possible — the downstream EM/Lloyd polish absorbs this (A/B-measured
    before any default change; see scripts/ab_paired.py). Same `w` padding
    contract as `kmeans_plus_plus` (zero-weight rows never selected; padded
    and unweighted programs draw bit-equally). `k_active` masks candidates
    [k_active:] out of every d2 update (rows [k_active:] are junk), but —
    unlike the exact path — the round split depends on the STATIC k, so the
    active prefix does NOT bit-match a standalone program of smaller k;
    ragged-k stacking under this knob is self-consistent, not
    sequential-equal.
    """
    n = X.shape[0]
    if k_active is None:
        k_active = jnp.asarray(k, jnp.int32)
    rounds = max(1, min(int(rounds), max(k - 1, 1)))

    key, sub = jax.random.split(key)
    ww = jnp.ones((n,), X.dtype) if w is None else w
    first = X[jax.random.choice(sub, n, p=ww / jnp.maximum(ww.sum(), 1e-12))]
    d2 = jnp.sum((X - first) ** 2, axis=1)

    # static near-equal split of the k-1 follow-ups across rounds
    base, rem = divmod(k - 1, rounds)
    sizes = [base + (1 if r < rem else 0) for r in range(rounds)]
    parts = [first[None]]
    offset = 1                                    # global center index
    for b in sizes:
        if b == 0:
            continue
        key, sub = jax.random.split(key)
        scores = d2 if w is None else d2 * w
        probs = scores / jnp.maximum(scores.sum(), 1e-12)
        idx = jax.random.choice(sub, n, shape=(b,), p=probs, replace=True)
        cand = X[idx]                                           # (b, d)
        live = (offset + jnp.arange(b)) < k_active              # (b,)
        cand_d2 = jnp.sum((X[:, None, :] - cand[None]) ** 2, -1)  # (n, b)
        cand_d2 = jnp.where(live[None], cand_d2, jnp.inf)
        d2 = jnp.minimum(d2, jnp.min(cand_d2, axis=1))
        parts.append(cand)
        offset += b
    return jnp.concatenate(parts, axis=0)


def _seed_centers(subkey, X, k, w=None, k_active=None,
                  seed_rounds: Optional[int] = None) -> jax.Array:
    """Dispatch between exact sequential k-means++ (reference parity,
    default) and the low-depth rounds variant (opt-in cost knob)."""
    if seed_rounds is None:
        return kmeans_plus_plus(subkey, X, k, w=w, k_active=k_active)
    return kmeans_plus_plus_rounds(subkey, X, k, rounds=int(seed_rounds),
                                   w=w, k_active=k_active)


# ---------------------------------------------------------------------------
# Spherical GMM EM (jittable, vmappable)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2, 3, 4),
         static_argnames=("k", "max_iter", "n_init", "em_dtype",
                          "seed_rounds"))
def gmm_spherical(key: jax.Array, X: jax.Array, k: int,
                  max_iter: int = 100, n_init: int = 3,
                  reg_covar: float = 1e-6, tol: float = 1e-3,
                  w: Optional[jax.Array] = None,
                  k_active: Optional[jax.Array] = None,
                  em_dtype: Optional[str] = None,
                  seed_rounds: Optional[int] = None
                  ) -> Tuple[jax.Array, jax.Array]:
    """Fit a spherical GMM; returns (means (k,2), sigmas (k,)).

    Runs `n_init` k-means++-seeded EM restarts and keeps the best final
    log-likelihood, mirroring sklearn's n_init semantics — including its
    `tol` convergence stop (|Δ mean log-likelihood| < 1e-3), which both
    matches sklearn's iteration count (~20-40 in practice, not max_iter)
    and cuts the on-device init time ~3x.

    Optional `w` (n,) point weights: zero-weight rows are padding that
    contributes nothing to any statistic — this is how lanes with different
    subsample sizes share one vmapped batch. w=None keeps the exact
    unweighted program.

    Optional `k_active` (traced scalar <= k): only the first k_active
    components exist; the rest are masked to exactly-zero responsibility
    every E-step, so different basis RESOLUTIONS pad to a common k and run
    as one vmapped program (a multi-resolution init is then ONE while_loop
    of max-iterations latency instead of one per resolution). Rows
    [k_active:] of the outputs are junk the caller slices off.

    Optional `em_dtype='bfloat16'` stores the (n, k)-sized EM tensors
    (pairwise d2, responsibilities) in bf16: EM is memory-bound on exactly
    those arrays, so halving their width roughly halves the per-iteration
    traffic. All reductions (component masses, means, variances,
    log-likelihood) still accumulate in f32 — bf16's ~0.4% relative error
    enters only through the stored distances/responsibilities, a
    statistical perturbation of the same order as a different k-means++
    draw (see scripts/ab_kmeans_divergence.py for the paired A/B).
    Default None keeps the exact f32 program.

    Optional `seed_rounds=R` swaps the exact sequential k-means++ seeding
    for the R-round batched variant (`kmeans_plus_plus_rounds`) — an
    opt-in cost knob; default None keeps reference-parity seeding.
    """
    n, d = X.shape
    big = jnp.bfloat16 if em_dtype == "bfloat16" else jnp.float32
    w_sum = None if w is None else jnp.maximum(jnp.sum(w), 1e-12)
    active = (None if k_active is None
              else jnp.arange(k) < k_active)    # (k,) component mask
    k_eff = jnp.asarray(k, jnp.float32) if k_active is None else k_active

    def pairwise_d2(means):
        # explicit elementwise differences: the |x|^2+|c|^2-2xc matmul trick
        # cancels catastrophically in low-precision matmuls (bf16, TF32)
        # and can go NEGATIVE,
        # which poisons log(var) downstream. O(n*k*d) elementwise is cheap at
        # these sizes and always >= 0. Differences are computed in f32 (no
        # cancellation); only the STORED (n, k) result takes em_dtype.
        diff = X[:, None, :] - means[None, :, :]          # (n, k, d)
        return jnp.sum(diff * diff, axis=-1).astype(big)  # (n, k)

    def em_once(subkey):
        means0 = _seed_centers(subkey, X, k, w=w, k_active=k_active,
                               seed_rounds=seed_rounds)
        if w is None:
            var0 = jnp.var(X) * jnp.ones((k,)) + reg_covar
        else:
            mu = jnp.sum(X * w[:, None], 0) / w_sum
            var0 = (jnp.sum(w[:, None] * (X - mu) ** 2) / (w_sum * d)
                    * jnp.ones((k,)) + reg_covar)
        weights0 = (jnp.full((k,), 1.0 / k) if active is None
                    else jnp.where(active, 1.0 / k_eff, 0.0))

        def estep(d2, var, weights):
            # manual logsumexp: ONE exp pass (logsumexp + a separate resp
            # exp would double the transcendental cost, which dominates EM
            # at (n, k) ~ 10k x 121)
            log_w = jnp.log(jnp.maximum(weights, 1e-30))
            log_prob = (-0.5 * (d2.astype(jnp.float32) / var[None]
                                + d * jnp.log(2 * jnp.pi * var)[None])
                        + log_w[None])
            if active is not None:
                # exp(-1e30 - m) underflows to exactly 0: padded components
                # get exactly-zero responsibility and never perturb the sums
                log_prob = jnp.where(active[None], log_prob, -1e30)
            m = jnp.max(log_prob, axis=1, keepdims=True)
            p = jnp.exp(log_prob - m)
            s = jnp.sum(p, axis=1, keepdims=True)
            resp = p / s
            log_norm = m[:, 0] + jnp.log(s[:, 0])
            if w is not None:
                resp = resp * w[:, None]
                ll = jnp.sum(w * log_norm) / w_sum
            else:
                ll = jnp.mean(log_norm)
            return resp.astype(big), ll

        def cond(state):
            _, _, _, _, ll_prev, ll, it = state
            first = it < 1
            return jnp.logical_and(
                it < max_iter,
                jnp.logical_or(first, jnp.abs(ll - ll_prev) >= tol))

        def body(state):
            # d2 is carried: the var update's distances at the NEW means are
            # exactly the next E-step's distances — one pairwise pass/iter
            means, var, weights, d2, _, ll_prev, it = state
            resp, ll = estep(d2, var, weights)
            nk = resp.sum(axis=0, dtype=jnp.float32) + 1e-10
            means_new = jnp.matmul(resp.T, X,
                                   preferred_element_type=jnp.float32
                                   ) / nk[:, None]
            d2_new = pairwise_d2(means_new)
            var_new = ((resp * d2_new).sum(axis=0, dtype=jnp.float32)
                       / (nk * d))
            var_new = jnp.maximum(var_new, 0.0) + reg_covar
            weights_new = nk / (n if w is None else w_sum)
            return (means_new, var_new, weights_new, d2_new,
                    ll_prev, ll, it + 1)

        init = (means0, var0, weights0, pairwise_d2(means0),
                -jnp.inf, -jnp.inf, jnp.asarray(0, jnp.int32))
        means, var, weights, d2, _, _, _ = jax.lax.while_loop(cond, body, init)
        _, ll_final = estep(d2, var, weights)
        return means, jnp.sqrt(var), ll_final

    keys = jax.random.split(key, n_init)
    means_all, sigmas_all, lls = jax.vmap(em_once)(keys)
    best = jnp.argmax(lls)
    return means_all[best], sigmas_all[best]


@partial(jax.jit, static_argnums=(2,),
         static_argnames=("ks", "max_iter", "n_init", "em_dtype",
                          "seed_rounds"))
def gmm_spherical_multi(keys_res: jax.Array, X: jax.Array,
                        ks: Tuple[int, ...],
                        max_iter: int = 100, n_init: int = 3,
                        reg_covar: float = 1e-6, tol: float = 1e-3,
                        w: Optional[jax.Array] = None,
                        em_dtype: Optional[str] = None,
                        seed_rounds: Optional[int] = None):
    """All `ks` resolutions of a spherical GMM as ONE fused EM loop.

    The sequential multi-resolution program (`_batched_gmm_multi`) runs one
    EM while_loop per resolution: total device iterations = sum over
    resolutions, and every iteration pays the loop body's fixed kernel-launch
    latency three times over. The k_active-PADDED merge (pad 25/81 -> 121 and
    vmap) costs 1.6x the memory traffic of the unpadded resolutions. This
    version merges along the COMPONENT axis
    instead: the (n, 25+81+121) tensors are exactly the union of the three
    programs' — zero padding — and all per-column work (d2, log-prob, exp,
    resp.T @ X) fuses into one kernel stream. Only the normalization is
    segment-structured (per-resolution slice max/sum, R tiny reductions).
    Iterations run to the slowest resolution's convergence with converged
    segments FROZEN at their own sklearn-style tol stop (param columns
    where-gated), so each resolution's stopping rule is per-restart exact —
    slightly CLOSER to sklearn's independent n_init fits than
    `gmm_spherical`'s lockstep-restart loop, and measured metric-neutral
    (scripts/ab_interleaved.py --b init_gmm_fused=true) before any default
    flip.

    `keys_res` is the (R,) stack of per-resolution keys (the caller's
    `fold_in(key, i)` stream — seeding is bit-identical to the sequential
    path: same subkeys, same `_seed_centers` draws per (resolution,
    restart)). Returns a tuple of (means (k_r, 2), sigmas (k_r,)) pairs.
    Same `w` / `em_dtype` / `seed_rounds` contracts as `gmm_spherical`.
    """
    n, d = X.shape
    R = len(ks)
    K = int(sum(ks))
    offs = np.cumsum([0] + list(ks))
    seg_id = jnp.asarray(np.repeat(np.arange(R), np.asarray(ks)))   # (K,)
    k_col = jnp.asarray(np.repeat(np.asarray(ks, np.float32),
                                  np.asarray(ks)))                  # (K,)
    big = jnp.bfloat16 if em_dtype == "bfloat16" else jnp.float32
    w_sum = None if w is None else jnp.maximum(jnp.sum(w), 1e-12)

    def pairwise_d2(means):
        # same explicit-difference form as gmm_spherical (no matmul-trick
        # cancellation); only the stored (n, K) result takes em_dtype
        diff = X[:, None, :] - means[None, :, :]
        return jnp.sum(diff * diff, axis=-1).astype(big)

    def seg_reduce(a, op):
        # per-resolution column-block reduction: (n, K) -> (n, R). R static
        # slices of one fused producer — XLA emits R small reduces, no
        # gather/segment machinery.
        return jnp.stack([op(a[:, offs[r]:offs[r + 1]]) for r in range(R)],
                         axis=1)

    def estep(d2, var, weights):
        log_w = jnp.log(jnp.maximum(weights, 1e-30))
        log_prob = (-0.5 * (d2.astype(jnp.float32) / var[None]
                            + d * jnp.log(2 * jnp.pi * var)[None])
                    + log_w[None])                               # (n, K)
        m = seg_reduce(log_prob, lambda a: jnp.max(a, axis=1))   # (n, R)
        p = jnp.exp(log_prob - jnp.take(m, seg_id, axis=1))
        s = seg_reduce(p, lambda a: jnp.sum(a, axis=1))          # (n, R)
        resp = p / jnp.take(s, seg_id, axis=1)
        log_norm = m + jnp.log(s)                                # (n, R)
        if w is not None:
            resp = resp * w[:, None]
            ll = jnp.sum(w[:, None] * log_norm, axis=0) / w_sum  # (R,)
        else:
            ll = jnp.mean(log_norm, axis=0)
        return resp.astype(big), ll

    def em_once(subkeys):
        # subkeys (R,) — one seeding key per resolution, exactly the key
        # gmm_spherical's em_once would receive for this restart
        means0 = jnp.concatenate(
            [_seed_centers(subkeys[r], X, ks[r], w=w,
                           seed_rounds=seed_rounds) for r in range(R)], 0)
        if w is None:
            var0 = jnp.var(X) * jnp.ones((K,)) + reg_covar
        else:
            mu = jnp.sum(X * w[:, None], 0) / w_sum
            var0 = (jnp.sum(w[:, None] * (X - mu) ** 2) / (w_sum * d)
                    * jnp.ones((K,)) + reg_covar)
        weights0 = 1.0 / k_col
        done0 = jnp.zeros((R,), bool)

        def cond(state):
            *_, done, it = state
            return jnp.logical_and(it < max_iter, ~jnp.all(done))

        def body(state):
            means, var, weights, d2, ll_prev, ll, done, it = state
            resp, ll_cur = estep(d2, var, weights)
            act_col = jnp.take(~done, seg_id)                    # (K,)
            nk = resp.sum(axis=0, dtype=jnp.float32) + 1e-10
            means_new = jnp.matmul(resp.T, X,
                                   preferred_element_type=jnp.float32
                                   ) / nk[:, None]
            means_new = jnp.where(act_col[:, None], means_new, means)
            d2_new = pairwise_d2(means_new)
            var_new = ((resp * d2_new).sum(axis=0, dtype=jnp.float32)
                       / (nk * d))
            var_new = jnp.maximum(var_new, 0.0) + reg_covar
            var_new = jnp.where(act_col, var_new, var)
            weights_new = nk / (n if w is None else w_sum)
            weights_new = jnp.where(act_col, weights_new, weights)
            ll_prev_new = jnp.where(~done, ll, ll_prev)
            ll_new = jnp.where(~done, ll_cur, ll)
            done_new = jnp.logical_or(
                done, jnp.logical_and(it >= 1,
                                      jnp.abs(ll_new - ll_prev_new) < tol))
            return (means_new, var_new, weights_new, d2_new,
                    ll_prev_new, ll_new, done_new, it + 1)

        init = (means0, var0, weights0, pairwise_d2(means0),
                jnp.full((R,), -jnp.inf), jnp.full((R,), -jnp.inf),
                done0, jnp.asarray(0, jnp.int32))
        means, var, weights, d2, *_ = jax.lax.while_loop(cond, body, init)
        _, ll_final = estep(d2, var, weights)
        return means, jnp.sqrt(var), ll_final

    # per-(resolution, restart) seeding keys: split each resolution's key
    # into n_init restarts, exactly as gmm_spherical does
    subkeys = jnp.stack([jax.random.split(keys_res[r], n_init)
                         for r in range(R)], axis=1)    # (n_init, R, key)
    means_all, sigmas_all, lls = jax.vmap(em_once)(subkeys)  # lls (ni, R)
    best = jnp.argmax(lls, axis=0)                            # (R,)
    return tuple((means_all[best[r], offs[r]:offs[r + 1]],
                  sigmas_all[best[r], offs[r]:offs[r + 1]])
                 for r in range(R))


# ---------------------------------------------------------------------------
# Balanced k-means (jittable, vmappable)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6),
         static_argnames=("k", "max_iter", "sinkhorn_iters", "eps_scale",
                          "n_init", "seed_rounds"))
def balanced_kmeans(key: jax.Array, X: jax.Array, k: int,
                    max_iter: int = 50, sinkhorn_iters: int = 40,
                    eps_scale: float = 0.02, n_init: int = 3,
                    w: Optional[jax.Array] = None,
                    k_active: Optional[jax.Array] = None,
                    seed_rounds: Optional[int] = None) -> jax.Array:
    """Balanced k-means via Sinkhorn optimal transport. Returns centers (k, 2).

    Each Lloyd iteration solves an entropically regularized OT problem
    between points (mass 1/n each) and clusters (capacity 1/k each) in the
    log domain, then updates centers as transport-weighted means. Cluster
    masses are exactly balanced by construction — the same equal-coverage
    property as the reference's min-cost-flow KMeansConstrained
    (st_interp.py:340-431), without a combinatorial solver. `n_init`
    k-means++-seeded restarts keep the best final transport cost, mirroring
    the reference's n_init=3 (st_interp.py:387-394).

    Optional `k_active` (traced scalar <= k): clusters [k_active:] get
    -inf log-capacity, so the transport plan routes exactly zero mass to
    them — different resolutions pad to one k and share one program (see
    gmm_spherical). Rows [k_active:] of the result are junk.
    """
    n = X.shape[0]
    if w is None:
        log_a = -jnp.log(float(n))      # per-point mass 1/n
    else:
        # zero-weight rows are padding: effectively -inf log-mass
        log_a = jnp.where(w > 0,
                          jnp.log(jnp.maximum(w, 1e-30)
                                  / jnp.maximum(jnp.sum(w), 1e-12)),
                          -1e30)
    if k_active is None:
        active = None
        k_eff = float(k)
        log_b = -jnp.log(float(k))      # per-cluster capacity 1/k
    else:
        active = jnp.arange(k) < k_active                    # (k,)
        k_eff = k_active.astype(jnp.float32)
        log_b = jnp.where(active, -jnp.log(k_eff), -1e30)

    def pairwise(centers):
        diff = X[:, None, :] - centers[None, :, :]
        return jnp.sum(diff * diff, axis=-1)                 # (n, k) >= 0

    def _active_mean_d2(d2):
        # mean over ACTIVE columns only (pad columns' distances would shift
        # the entropic eps away from the unpadded program's value)
        if active is None:
            return jnp.mean(d2)
        return jnp.sum(d2 * active[None]) / (n * k_eff)

    def ot_plan(d2):
        if w is None:
            eps = eps_scale * _active_mean_d2(d2) + 1e-9
        else:
            eps = (eps_scale * jnp.sum(d2 * w[:, None]
                                       * (1.0 if active is None
                                          else active[None]))
                   / jnp.maximum(jnp.sum(w) * k_eff, 1e-12) + 1e-9)

        def sink(carry, _):
            f, g = carry
            f = eps * (log_a - jax.scipy.special.logsumexp(
                (g[None, :] - d2) / eps, axis=1))
            g = eps * (log_b - jax.scipy.special.logsumexp(
                (f[:, None] - d2) / eps, axis=0))
            return (f, g), None

        (f, g), _ = jax.lax.scan(sink, (jnp.zeros(n), jnp.zeros(k)),
                                 None, length=sinkhorn_iters)
        return jnp.exp((f[:, None] + g[None, :] - d2) / eps)  # (n, k)

    def fit_once(subkey):
        def body(centers, _):
            P = ot_plan(pairwise(centers))
            mass = P.sum(axis=0) + 1e-12                      # ~1/k each
            return (P.T @ X) / mass[:, None], None

        centers0 = _seed_centers(subkey, X, k, w=w, k_active=k_active,
                                 seed_rounds=seed_rounds)
        centers, _ = jax.lax.scan(body, centers0, None, length=max_iter)
        d2 = pairwise(centers)
        cost = jnp.sum(ot_plan(d2) * d2)
        return centers, cost

    keys = jax.random.split(key, n_init)
    centers_all, costs = jax.vmap(fit_once)(keys)
    return centers_all[jnp.argmin(costs)]


# ---------------------------------------------------------------------------
# Bandwidth helpers
# ---------------------------------------------------------------------------

def _nn_bandwidths(centers: np.ndarray, n_neighbors: int = 4,
                   scale: float = 2.5) -> np.ndarray:
    """2.5 x mean distance to the `n_neighbors` nearest other centers
    (ref st_interp.py:306-323, :400-416), floored at 0.25x the uniform-grid
    bandwidth for the same k.

    The floor is a robustness extension: when clustering has fewer unique
    training locations than clusters (e.g. site-wise observation with
    k > n_obs_sites), duplicate centers make nearest distances 0 and the
    log-bandwidth parameterization NaNs — the reference has no guard and
    diverges identically there; its GMM path applies the same 0.25x floor
    (st_interp.py:250-255).
    """
    k = centers.shape[0]
    if k == 1:
        return np.array([scale], dtype=np.float32)
    diff = centers[:, None, :] - centers[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    np.fill_diagonal(dist, np.inf)
    nn = min(n_neighbors, k - 1)
    nearest = np.sort(dist, axis=1)[:, :nn]
    bw = (nearest.mean(axis=1) * scale).astype(np.float32)
    floor = 0.25 * scale / max(np.sqrt(k) - 1.0, 1.0)   # 0.25 x uniform bw
    return np.maximum(bw, np.float32(floor))


def _subsample(train_coords: np.ndarray, cap: Optional[int] = None,
               rng=None) -> np.ndarray:
    """Reference-stream subsample. `rng` (a np.random.RandomState) draws the
    bit-identical sequence to the global np.random functions — the module-
    level functions delegate to a global RandomState — without touching
    (or locking) the global stream."""
    cap = MAX_INIT_SAMPLES if cap is None else int(cap)
    if len(train_coords) > cap:
        idx = (rng or np.random).choice(len(train_coords), cap,
                                        replace=False)
        return train_coords[idx]
    return train_coords


# ---------------------------------------------------------------------------
# Top-level dispatcher
# ---------------------------------------------------------------------------

_BATCH_FIT_CACHE = {}


def _batched_gmm_multi(ks: Tuple[int, ...], weighted: bool,
                       em_dtype: Optional[str] = None,
                       n_init: Optional[int] = None,
                       seed_rounds: Optional[int] = None,
                       fused: bool = False):
    """All resolutions of a batched GMM init as ONE device program (one
    dispatch instead of one per resolution).

    Resolutions run as sequential EM programs inside the one dispatch. A
    k_active-masked merge (pad all resolutions to max(ks) and vmap them —
    the kernels support it, see gmm_spherical) would pay ~1.6x memory
    traffic at the bench workload's [25, 81, 121] to save while_loop
    latency; which wins on the GPU is unmeasured (ROADMAP Speed item 7)."""
    ni = 3 if n_init is None else int(n_init)
    key = ("gmm_multi", ks, weighted, em_dtype, ni, seed_rounds, fused)
    fn = _BATCH_FIT_CACHE.get(key)
    if fn is None and fused:
        # one concat-k EM loop for all resolutions (gmm_spherical_multi);
        # seeding keys per resolution match the sequential path's fold_in
        def program(keys_b, X_b, w_b):
            def per_lane(kk, X, ww):
                kres = jnp.stack([jax.random.fold_in(kk, i)
                                  for i in range(len(ks))])
                return gmm_spherical_multi(kres, X, ks=ks, w=ww,
                                           em_dtype=em_dtype, n_init=ni,
                                           seed_rounds=seed_rounds)
            if weighted:
                return jax.vmap(per_lane)(keys_b, X_b, w_b)
            return jax.vmap(lambda kk, X: per_lane(kk, X, None)
                            )(keys_b, X_b)
        fn = jax.jit(program)
        _BATCH_FIT_CACHE[key] = fn
    if fn is None:
        def program(keys_b, X_b, w_b):
            out = []
            for i, k in enumerate(ks):
                sub = jax.vmap(lambda kk, i=i: jax.random.fold_in(kk, i))(keys_b)
                if weighted:
                    out.append(jax.vmap(
                        lambda kk, X, ww, k=k: gmm_spherical(
                            kk, X, k, w=ww, em_dtype=em_dtype, n_init=ni,
                            seed_rounds=seed_rounds)
                    )(sub, X_b, w_b))
                else:
                    out.append(jax.vmap(
                        lambda kk, X, k=k: gmm_spherical(
                            kk, X, k, em_dtype=em_dtype, n_init=ni,
                            seed_rounds=seed_rounds)
                    )(sub, X_b))
            return tuple(out)
        fn = jax.jit(program)
        _BATCH_FIT_CACHE[key] = fn
    return fn


def _batched_bkm_multi(ks: Tuple[int, ...], weighted: bool,
                       seed_rounds: Optional[int] = None):
    """One-dispatch multi-resolution balanced k-means (see _batched_gmm_multi
    for why resolutions are sequential, not k_active-merged)."""
    key = ("bkm_multi", ks, weighted, seed_rounds)
    fn = _BATCH_FIT_CACHE.get(key)
    if fn is None:
        def program(keys_b, X_b, w_b):
            out = []
            for i, k in enumerate(ks):
                sub = jax.vmap(lambda kk, i=i: jax.random.fold_in(
                    kk, 100 + i))(keys_b)
                if weighted:
                    out.append(jax.vmap(
                        lambda kk, X, ww, k=k: balanced_kmeans(
                            kk, X, k, w=ww, seed_rounds=seed_rounds)
                    )(sub, X_b, w_b))
                else:
                    out.append(jax.vmap(
                        lambda kk, X, k=k: balanced_kmeans(
                            kk, X, k, seed_rounds=seed_rounds)
                    )(sub, X_b))
            return tuple(out)
        fn = jax.jit(program)
        _BATCH_FIT_CACHE[key] = fn
    return fn


def _nn_bandwidths_jnp(centers_b: jax.Array, k: int, n_neighbors: int = 4,
                       scale: float = 2.5) -> jax.Array:
    """Vectorized `_nn_bandwidths` over a lane axis, on device.

    centers_b (M, k, 2) -> (M, k). Same math (incl. the 0.25x uniform-bw
    floor); keeping it on device lets the batched init return device arrays
    with no host round trip."""
    if k == 1:
        return jnp.full((centers_b.shape[0], 1), scale, jnp.float32)
    diff = centers_b[:, :, None, :] - centers_b[:, None, :, :]
    dist = jnp.sqrt(jnp.sum(diff * diff, -1))
    # mask the diagonal via where, NOT `dist + eye*inf`: eye*inf puts
    # 0*inf = NaN on every OFF-diagonal entry and poisons all bandwidths
    dist = jnp.where(jnp.eye(k, dtype=bool)[None], jnp.inf, dist)
    nn = min(n_neighbors, k - 1)
    nearest = -jax.lax.top_k(-dist, nn)[0]            # (M, k, nn) smallest
    bw = nearest.mean(axis=-1) * scale
    floor = 0.25 * scale / max(np.sqrt(k) - 1.0, 1.0)
    return jnp.maximum(bw, floor).astype(jnp.float32)


def init_spatial_centers_batch(
    method: str,
    n_centers: Sequence[int],
    train_coords_list: list,
    keys: jax.Array,
    rng_states: Optional[list] = None,
    device_out: bool = False,
    em_dtype: Optional[str] = None,
    gmm_n_init: Optional[int] = None,
    subsample: Optional[int] = None,
    seed_rounds: Optional[int] = None,
    gmm_fused: bool = False,
):
    """Data-adaptive initialization for a whole experiment batch at once.

    One vmapped device program for all resolutions instead of 3 dispatches
    per lane. With `rng_states` (per-lane numpy RNG states captured at the
    end of each lane's setup — ExperimentSetup.np_rng_state), every lane's
    subsample/site draws replay the SEQUENTIAL engine's stream exactly, so
    `--engine vmap` and sequential runs produce identical data-adaptive
    inits for the same seed (round-1 review item). Lanes whose subsample
    sizes differ are zero-weight padded to a common shape (the weighted
    EM/Sinkhorn paths ignore padding exactly).

    Returns a list of (centers, bandwidths) numpy pairs, one per lane — or,
    with `device_out=True`, ONE device pair (centers_b (M, K, 2), bw_b
    (M, K)) with the resolutions already concatenated: the consumer
    (prepare_carry_batch) runs on device, so pulling centers to host only to
    re-upload them would cost several transfers per batch for nothing.

    `gmm_n_init` / `subsample` / `seed_rounds` override the reference-parity
    GMM restart count (3), the init subsample cap (10k), and the exact
    sequential k-means++ seeding (None → R-round batched seeding) — opt-in
    cost knobs (cfg.extra init_gmm_n_init / init_subsample /
    init_seed_rounds) whose end-metric effect is measured with
    scripts/ab_paired.py before any default changes.
    """
    from st_dadk_tpu.utils.seed import GLOBAL_NP_RNG_LOCK

    def _stack_device(pairs):
        return (jnp.asarray(np.stack([c for c, _ in pairs])),
                jnp.asarray(np.stack([b for _, b in pairs])))

    M = len(train_coords_list)
    if method == "uniform":
        c, bw = uniform_grid_centers(n_centers)
        if device_out:
            return _stack_device([(c, bw)] * M)
        return [(c, bw)] * M
    if method in ("random_site", "kmeans_exact"):
        # host-side paths; replay each lane's sequential stream (global-RNG
        # section: locked against the pipelined prepare thread)
        out = []
        with GLOBAL_NP_RNG_LOCK:
            for i, tc in enumerate(train_coords_list):
                if rng_states is not None:
                    np.random.set_state(rng_states[i])
                else:
                    np.random.seed(int(np.asarray(
                        jax.random.key_data(keys[i])).ravel()[-1]) % (2 ** 31))
                out.append(init_spatial_centers(
                    method, n_centers, tc, key=keys[i], em_dtype=em_dtype,
                    gmm_n_init=gmm_n_init, subsample=subsample,
                    seed_rounds=seed_rounds))
        if device_out:
            return _stack_device(out)
        return out

    # lock-free: the sequential-exact replay runs on a PRIVATE RandomState
    # seeded from each lane's captured stream state (bit-identical draws to
    # np.random.set_state + np.random.choice — the global functions delegate
    # to a module-level RandomState). Taking GLOBAL_NP_RNG_LOCK here
    # would serialize the pipelined stream: the prepare thread holds the
    # lock for the whole mask-sampling pass of batch k+2, so the main
    # thread's init dispatch for batch k+1 would idle the device.
    Xs = []
    for i, tc in enumerate(train_coords_list):
        cap = MAX_INIT_SAMPLES if subsample is None else int(subsample)
        if rng_states is not None:
            rs = np.random.RandomState()
            rs.set_state(rng_states[i])
            sub = _subsample(tc, cap, rng=rs)
        elif len(tc) > cap:
            rng = np.random.default_rng(
                np.asarray(jax.random.key_data(keys[i]))[-1])
            sub = tc[rng.choice(len(tc), cap, replace=False)]
        else:
            sub = tc
        Xs.append(np.asarray(sub, np.float32))

    n_max = max(len(x) for x in Xs)
    uniform_size = all(len(x) == n_max for x in Xs)
    if uniform_size:
        X_b = jnp.asarray(np.stack(Xs))
        w_b = None
    else:
        X_pad = np.zeros((M, n_max, 2), np.float32)
        w_pad = np.zeros((M, n_max), np.float32)
        for i, x in enumerate(Xs):
            X_pad[i, : len(x)] = x
            w_pad[i, : len(x)] = 1.0
        X_b = jnp.asarray(X_pad)
        w_b = jnp.asarray(w_pad)

    per_lane = [[] for _ in range(M)]
    ks = tuple(int(k) for k in n_centers)
    if device_out:
        # assemble (M, K, 2) / (M, K) entirely on device — bandwidth math is
        # a handful of elementwise ops (gmm) or a (k x k) top-k (balanced)
        cparts, bparts = [], []
        if method == "gmm":
            for k, (means_b, sig_b) in zip(
                    ks, _batched_gmm_multi(ks, w_b is not None, em_dtype,
                                           gmm_n_init, seed_rounds,
                                           fused=gmm_fused
                                           )(keys, X_b, w_b)):
                bw_min = 0.25 * uniform_bandwidth_for(k)
                cparts.append(means_b)
                bparts.append(jnp.maximum(4.23 * 2.5 * sig_b, bw_min
                                          ).astype(jnp.float32))
        elif method == "kmeans_balanced":
            for k, centers_b in zip(
                    ks, _batched_bkm_multi(ks, w_b is not None, seed_rounds
                                           )(keys, X_b, w_b)):
                cparts.append(centers_b)
                if k == 1:
                    bparts.append(jnp.full(
                        (M, 1), uniform_bandwidth_for(int(n_centers[0])),
                        jnp.float32))
                else:
                    bparts.append(_nn_bandwidths_jnp(centers_b, k))
        else:
            raise ValueError(f"Unknown init_method: {method}")
        return (jnp.concatenate(cparts, axis=1),
                jnp.concatenate(bparts, axis=1))
    if method == "gmm":
        results = _batched_gmm_multi(ks, w_b is not None, em_dtype,
                                     gmm_n_init, seed_rounds,
                                     fused=gmm_fused)(keys, X_b, w_b)
        for k, (means_b, sig_b) in zip(ks, results):
            means_np = np.asarray(means_b, np.float32)
            sig_np = np.asarray(sig_b)
            bw_min = 0.25 * uniform_bandwidth_for(k)
            for i in range(M):
                bw = np.clip(4.23 * 2.5 * sig_np[i],
                             bw_min, np.inf).astype(np.float32)
                per_lane[i].append((means_np[i], bw))
    elif method == "kmeans_balanced":
        results = _batched_bkm_multi(ks, w_b is not None,
                                     seed_rounds)(keys, X_b, w_b)
        for k, centers_b in zip(ks, results):
            centers_np = np.asarray(centers_b, np.float32)
            for i in range(M):
                bw = _nn_bandwidths(centers_np[i])
                if k == 1:
                    bw = np.array([uniform_bandwidth_for(int(n_centers[0]))],
                                  np.float32)
                per_lane[i].append((centers_np[i], bw))
    else:
        raise ValueError(f"Unknown init_method: {method}")

    return [(np.concatenate([c for c, _ in lane], axis=0),
             np.concatenate([b for _, b in lane], axis=0))
            for lane in per_lane]


def init_spatial_centers(
    method: str,
    n_centers: Sequence[int],
    train_coords: Optional[np.ndarray] = None,
    key: Optional[jax.Array] = None,
    em_dtype: Optional[str] = None,
    gmm_n_init: Optional[int] = None,
    subsample: Optional[int] = None,
    seed_rounds: Optional[int] = None,
    gmm_fused: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (centers (sum_k, 2), bandwidths (sum_k,)) for any init method.

    For data-adaptive methods, `train_coords` are the training coordinates
    WITH temporal duplicates (density weighting, ref st_interp.py:291-294) and
    `key` seeds the on-device clustering. Subsampling draws from the global
    numpy RNG exactly like the reference (which relies on the experiment
    seed set beforehand).
    """
    if method == "uniform":
        return uniform_grid_centers(n_centers)

    if train_coords is None:
        raise ValueError(f"train_coords required for {method} initialization")
    if key is None:
        key = jax.random.PRNGKey(42)

    centers_list, bw_list = [], []

    if method == "gmm":
        X = jnp.asarray(_subsample(train_coords, subsample), jnp.float32)
        ni = 3 if gmm_n_init is None else int(gmm_n_init)
        if gmm_fused:
            kres = jnp.stack([jax.random.fold_in(key, i)
                              for i in range(len(n_centers))])
            fits = gmm_spherical_multi(
                kres, X, ks=tuple(int(k) for k in n_centers),
                em_dtype=em_dtype, n_init=ni, seed_rounds=seed_rounds)
        else:
            fits = [gmm_spherical(jax.random.fold_in(key, i), X, int(k),
                                  em_dtype=em_dtype, n_init=ni,
                                  seed_rounds=seed_rounds)
                    for i, k in enumerate(n_centers)]
        for k, (means, sigmas) in zip(n_centers, fits):
            centers = np.asarray(means, np.float32)
            bw_raw = 4.23 * 2.5 * np.asarray(sigmas)
            bw_min = 0.25 * uniform_bandwidth_for(int(k))
            bw = np.clip(bw_raw, bw_min, np.inf).astype(np.float32)
            centers_list.append(centers)
            bw_list.append(bw)

    elif method == "random_site":
        # numpy path — identical call pattern to the reference (:296-332)
        for k in n_centers:
            k = int(k)
            if k > len(train_coords):
                idx = np.random.choice(len(train_coords), k, replace=True)
            else:
                idx = np.random.choice(len(train_coords), k, replace=False)
            centers = train_coords[idx].astype(np.float32)
            bw = _nn_bandwidths(centers)
            if k == 1:
                bw = np.array([uniform_bandwidth_for(int(n_centers[0]))],
                              np.float32)
            centers_list.append(centers)
            bw_list.append(bw)

    elif method == "kmeans_balanced":
        X = jnp.asarray(_subsample(train_coords, subsample), jnp.float32)
        for i, k in enumerate(n_centers):
            centers = np.asarray(
                balanced_kmeans(jax.random.fold_in(key, 100 + i), X, int(k),
                                seed_rounds=seed_rounds),
                np.float32)
            bw = _nn_bandwidths(centers)
            if int(k) == 1:
                bw = np.array([uniform_bandwidth_for(int(n_centers[0]))],
                              np.float32)
            centers_list.append(centers)
            bw_list.append(bw)

    elif method == "kmeans_exact":
        # opt-in exact solver matching the reference's KMeansConstrained
        # semantics (min-cost assignment per Lloyd step, exact floor/ceil
        # cluster sizes, random_state=42/n_init=3/max_iter=100 —
        # st_interp.py:340-431); host-side and slower than the Sinkhorn
        # default. See ops/kmeans_exact.py.
        from st_dadk_tpu.ops.kmeans_exact import kmeans_constrained
        X = np.asarray(_subsample(train_coords, subsample), np.float64)
        for k in n_centers:
            k = int(k)
            centers, _ = kmeans_constrained(X, k)
            centers = centers.astype(np.float32)
            bw = _nn_bandwidths(centers)
            if k == 1:
                bw = np.array([uniform_bandwidth_for(int(n_centers[0]))],
                              np.float32)
            centers_list.append(centers)
            bw_list.append(bw)

    else:
        raise ValueError(f"Unknown init_method: {method}")

    return (np.concatenate(centers_list, axis=0),
            np.concatenate(bw_list, axis=0))
