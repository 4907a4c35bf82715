#!/usr/bin/env python
"""Time the plain XLA basis model at large (N, k).

Maps the 3a/3b-scale regime (N up to 1M points, k up to 4096 centers),
where the (N, k) basis matrix — 4 GB at N=1M, k=1024 — dominates device
memory traffic:

  - training: one jitted composite-loss gradient step (learnable Wendland
    basis + MLP);
  - inference: chunked dense predict;
  - a configuration that does not fit is reported as such.

Writes chiprun_out/large_n.json (or --out) and prints a markdown table.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
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

from st_dadk_tpu.config import ExperimentConfig  # noqa: E402
from st_dadk_tpu.models.st_interp import (  # noqa: E402
    init_model,
    spec_from_config,
)
from st_dadk_tpu.train.loop import LoopSpec, training_loss  # noqa: E402


def time_call(fn, *args, reps=10, warmup=2):
    # one block_until_ready after the rep loop: dispatch overlaps the device
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps * 1000.0   # ms


def bench_case(N: int, k: int, mode: str, reps: int):
    cfg = ExperimentConfig.from_dict(dict(
        k_spatial_centers=[k], k_temporal_centers=[10, 15, 45],
        hidden_dims=[256, 256, 128], dropout=0.0, layernorm=True,
        spatial_learnable=True, regression_type="mean",
    ))
    spec = spec_from_config(cfg)
    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.uniform(size=(N, 2)), jnp.float32)
    t = jnp.asarray(rng.uniform(size=(N, 1)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((N, 1)), jnp.float32)
    w = jnp.ones((N,), jnp.float32)
    # data-adaptive-ish centers: random training points, uniform bandwidth
    centers = np.asarray(rng.uniform(size=(k, 2)), np.float32)
    bw = np.full((k,), 2.5 / max(np.sqrt(k) - 1, 1), np.float32)
    params, consts = init_model(jax.random.PRNGKey(0), spec, centers, bw)

    if mode == "train":
        ls = LoopSpec(model=spec, regression_type="mean",
                      gradient_damping=True, damping_threshold=0.0,
                      damping_strength=5.0, domain_penalty_weight=0.01,
                      grad_clip=10.0)

        @jax.jit
        def step(p):
            return jax.grad(lambda q: training_loss(
                ls, q, consts, coords, t, y, w, train=True, rng=None))(p)

        return time_call(step, params, reps=reps)

    # inference: chunked dense predict through loop.predict's machinery
    from st_dadk_tpu.train.loop import _predict_chunked_raw
    n_chunks = max(1, N // 131072)
    Np = (N // n_chunks) * n_chunks
    fn = jax.jit(lambda p, c: _predict_chunked_raw(
        spec, p, consts, coords[:Np], t[:Np], n_chunks),
        static_argnums=())
    return time_call(fn, params, consts, reps=reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", type=int, nargs="+",
                    default=[131072, 524288, 1048576])
    ap.add_argument("--ks", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--modes", nargs="+", default=["train", "infer"],
                    choices=["train", "infer"])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "large_n.json"))
    args = ap.parse_args()

    rows = []
    for mode in args.modes:
        for N in args.ns:
            for k in args.ks:
                row = {"mode": mode, "N": N, "k": k}
                try:
                    row["ms"] = round(bench_case(N, k, mode, args.reps), 2)
                except Exception as e:
                    row["ms"] = f"OOM/err: {type(e).__name__}"
                print(f"[{mode}] N={N} k={k}: {row['ms']}", flush=True)
                rows.append(row)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print("\n| mode | N | k | ms |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['mode']} | {r['N']} | {r['k']} | {r['ms']} |")
    print(f"\n[OK] wrote {args.out}")


if __name__ == "__main__":
    main()
