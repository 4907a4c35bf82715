#!/usr/bin/env python
"""Time what XLA makes of the spatial basis -> first layer on the GPU.

Two shapes of the bench workload (k_spatial 25+81+121, k_temporal
10+15+45, first hidden layer 256):
  - dense eval: 2a_8's T*S = 100k points padded to 4 chunks of 32768
    (`eval_chunk`), basis + first Linear per chunk, and the whole chunked
    forward (`loop._predict_chunked_raw`) for context;
  - training step: 16 lanes (vmapped) x a minibatch of 4096 points, and of
    512 points (the bench workload's batch after adaptive batching), basis +
    first Linear forward, and forward + backward.

Each time is the host wall of 200 back-to-back calls ending in
block_until_ready, divided by 200 (dispatch overlaps the device). Beside it:
the least time the H100's published peaks allow (495 TFLOP/s TF32 dense,
67 TFLOP/s float32, 3.35 TB/s HBM; NVIDIA data sheet, SXM) for the bytes the
op must move (inputs + outputs) and the FLOPs it must do, the bound that
sets it, and the share of that bound reached. A large bf16 matrix product
and a large copy in the same process calibrate what the card reaches.

    python scripts/time_basis_layer1.py [--out chiprun_out/basis_layer1.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PEAK = {"tf32_flops": 495e12, "f32_flops": 67e12, "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12}
K_S, K_T, H1 = (25, 81, 121), (10, 15, 45), 256


def wall_per_call(fn, *args, reps: int = 200) -> float:
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def roofline(seconds: float, flops: float, nbytes: float,
             flop_peak: str = "tf32_flops") -> dict:
    t_flop = flops / PEAK[flop_peak]
    t_mem = nbytes / PEAK["hbm_bytes"]
    bound = max(t_flop, t_mem)
    return {"us": seconds * 1e6, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "bound": "compute" if t_flop >= t_mem else "memory",
            "roofline_us": bound * 1e6, "roofline_share": bound / seconds}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                          / "basis_layer1.json"))
    args = ap.parse_args()

    from st_dadk_tpu.utils.platform import enable_compile_cache, require_gpu
    dev = require_gpu()
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from st_dadk_tpu.models.st_interp import ModelSpec, init_model
    from st_dadk_tpu.ops.basis import spatial_basis_embed, temporal_basis_embed
    from st_dadk_tpu.train.loop import _predict_chunked_raw

    spec = ModelSpec(k_spatial_centers=K_S, k_temporal_centers=K_T,
                     hidden_dims=(256, 256, 128), spatial_learnable=True,
                     output_dim=5)
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    k_in = spec.input_dim
    rng = np.random.default_rng(0)

    def layer1(p, coords, t):
        phi = spatial_basis_embed(coords, p["basis"]["centers"],
                                  jnp.exp(p["basis"]["log_bandwidths"]))
        psi = temporal_basis_embed(t, consts["temporal_centers"],
                                   consts["temporal_bandwidths"])
        lin = p["mlp"]["linear_0"]
        return jnp.concatenate([phi, psi], 1) @ lin["w"] + lin["b"]

    res = {"device": {k: dev[k] for k in ("kind", "count", "nvidia_smi")},
           "method": "host wall of 200 back-to-back calls / 200"}

    # -- dense eval: 4 chunks of 32768 (100k points padded) ----------------
    chunk, n_chunks = 32768, 4
    n = chunk * n_chunks
    coords = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    t = jnp.asarray(rng.uniform(size=(n, 1)), jnp.float32)

    @jax.jit
    def dense_layer1(p, coords, t):
        def body(_, xs):
            return None, layer1(p, *xs)
        return jax.lax.scan(body, None, (coords.reshape(n_chunks, chunk, 2),
                                         t.reshape(n_chunks, chunk, 1)))[1]

    flops = 2.0 * n * k_in * H1
    nbytes = 4.0 * (n * 3 + k_in * H1 + n * H1)
    res["dense_eval_layer1"] = roofline(
        wall_per_call(dense_layer1, params, coords, t), flops, nbytes)
    fwd = jax.jit(lambda p, c, tt: _predict_chunked_raw(spec, p, consts, c,
                                                        tt, n_chunks))
    res["dense_eval_forward"] = {"us": wall_per_call(fwd, params, coords, t)
                                 * 1e6}

    # -- training step: 16 lanes x minibatch ---------------------------------
    M = 16
    params_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (M,) + x.shape), params)
    for bs in (4096, 512):
        cb = jnp.asarray(rng.uniform(size=(M, bs, 2)), jnp.float32)
        tb = jnp.asarray(rng.uniform(size=(M, bs, 1)), jnp.float32)
        f = jax.jit(jax.vmap(layer1))

        def fb(p, c, tt):
            h, vjp = jax.vjp(lambda q: layer1(q, c, tt), p)
            return vjp(jnp.ones_like(h))[0]
        fb = jax.jit(jax.vmap(fb))
        flops = 2.0 * M * bs * k_in * H1
        in_b = 4.0 * M * (bs * 3 + k_in * H1)
        res[f"train_layer1_fwd_b{bs}"] = roofline(
            wall_per_call(f, params_b, cb, tb), flops,
            in_b + 4.0 * M * bs * H1)
        # backward: dW = phi^T g and dphi = g W^T, two more GEMMs
        res[f"train_layer1_fwd_bwd_b{bs}"] = roofline(
            wall_per_call(fb, params_b, cb, tb), 3 * flops,
            in_b + 4.0 * M * (bs * H1 + k_in * H1 + 3 * sum(K_S)))

    # -- calibration ------------------------------------------------------------
    a = jnp.asarray(rng.standard_normal((8192, 8192)), jnp.bfloat16)
    mm = jax.jit(lambda x: x @ x)
    s = wall_per_call(mm, a, reps=50)
    res["calib_bf16_matmul_8192"] = {"us": s * 1e6,
                                     "tflops": 2 * 8192 ** 3 / s / 1e12}
    big = jnp.zeros((256 * 1024 * 1024,), jnp.float32)      # 1 GiB
    cp = jax.jit(lambda x: x + 1.0)
    s = wall_per_call(cp, big, reps=50)
    res["calib_copy_1GiB"] = {"us": s * 1e6,
                              "tbytes_per_s": 2 * big.nbytes / s / 1e12}

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
