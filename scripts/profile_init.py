#!/usr/bin/env python
"""Split the batched GMM init cost into k-means++ seeding vs EM, per
resolution, on the bench workload shapes (M=16 lanes, n=10k subsample,
k=[25, 81, 121], n_init=3).

Round-3 profile: the init is 0.69 s of a ~2.1 s steady-state batch (~33%).
This script answers the roadmap question "seeding (227 sequential scan
steps) or EM?" with on-device timings of each piece in isolation.
"""
from __future__ import annotations

import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from st_dadk_tpu.ops.init_centers import (gmm_spherical,  # noqa: E402
                                          kmeans_plus_plus,
                                          kmeans_plus_plus_rounds)

M = int(sys.argv[1]) if len(sys.argv) > 1 else 16
N = 10_000
KS = (25, 81, 121)
N_INIT = 3
REPS = 5


def timed(label, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(REPS):
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.time() - t0)
    print(f"  {label:<46} {min(ts)*1000:9.1f} ms (min of {REPS})",
          flush=True)
    return out


def main():
    rng = np.random.default_rng(0)
    X_b = jnp.asarray(rng.uniform(size=(M, N, 2)).astype(np.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), M)

    print(f"[profile_init] M={M} n={N} ks={KS} n_init={N_INIT} "
          f"on {jax.devices()[0].platform}", flush=True)

    # (seeding-only timings below reuse seed_unroll at the default unroll=8
    # — a separate factory without the unroll arg was an identical copy)
    def seed_unroll(k, u):
        @jax.jit
        def run(keys_b, X_b):
            def lane(key, X):
                subs = jax.random.split(key, N_INIT)
                return jax.vmap(
                    lambda s: kmeans_plus_plus(s, X, k, unroll=u))(subs)
            return jax.vmap(lane)(keys_b, X_b)
        return run

    # seeding only, per resolution (n_init restarts vmapped like gmm does)
    for k in KS:
        timed(f"kmeans++ seeding k={k} (x{N_INIT} restarts)",
              seed_unroll(k, 8), keys, X_b)

    # scan-unroll sweep on the largest resolution (exact same draws; only
    # the loop's dispatch granularity changes)
    for u in (1, 4, 8, 16, 32):
        timed(f"kmeans++ k={KS[-1]} unroll={u}",
              seed_unroll(KS[-1], u), keys, X_b)

    # low-depth batched seeding (init_seed_rounds knob): R rounds of i.i.d.
    # d2-weighted draws instead of k-1 sequential steps
    def seed_rounds_only(k, r):
        @jax.jit
        def run(keys_b, X_b):
            def lane(key, X):
                subs = jax.random.split(key, N_INIT)
                return jax.vmap(lambda s: kmeans_plus_plus_rounds(
                    s, X, k, rounds=r))(subs)
            return jax.vmap(lane)(keys_b, X_b)
        return run

    for r in (4, 8, 16):
        timed(f"kmeans++ ROUNDS k={KS[-1]} rounds={r}",
              seed_rounds_only(KS[-1], r), keys, X_b)

    # full gmm per resolution
    for k in KS:
        fn = jax.jit(jax.vmap(partial(gmm_spherical, k=k)),
                     static_argnames=())
        timed(f"gmm_spherical k={k} (seed+EM, n_init={N_INIT})",
              lambda kb, xb, fn=fn: fn(kb, xb), keys, X_b)

    # all three resolutions in one dispatch (what the engine runs)
    from st_dadk_tpu.ops.init_centers import _batched_gmm_multi
    fn = _batched_gmm_multi(KS, False)
    timed("one-dispatch multi-resolution (engine path)", fn, keys, X_b, None)

    # same with bf16 EM storage (init_em_dtype: bfloat16)
    fn16 = _batched_gmm_multi(KS, False, "bfloat16")
    timed("one-dispatch multi-resolution (bf16 EM)", fn16, keys, X_b, None)

    # same with low-depth seeding (init_seed_rounds: 8)
    fnr = _batched_gmm_multi(KS, False, None, None, 8)
    timed("one-dispatch multi-resolution (seed_rounds=8)",
          fnr, keys, X_b, None)

    # fused concat-k EM (init_gmm_fused: one while_loop over the 227-column
    # union instead of three sequential per-resolution loops)
    fnf = _batched_gmm_multi(KS, False, fused=True)
    timed("one-dispatch multi-resolution (FUSED concat-k)",
          fnf, keys, X_b, None)

    # fused + bf16 EM storage (the two levers stack)
    fnf16 = _batched_gmm_multi(KS, False, "bfloat16", fused=True)
    timed("one-dispatch multi-resolution (FUSED + bf16 EM)",
          fnf16, keys, X_b, None)


if __name__ == "__main__":
    main()
