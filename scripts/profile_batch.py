#!/usr/bin/env python
"""Per-phase profiling of the vmapped batch engine on the bench workload.

Times every host<->device interaction of one steady-state batch separately:
setup, stacking/upload, each chunk dispatch vs its history pull vs the
stopped-flag sync, batched eval, and finalize. Run on the GPU to see where
a batch's wall goes beyond the device scan.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)
apply_platform_env()
enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from st_dadk_tpu.config import ExperimentConfig

from st_dadk_tpu.bench_workload import bench_workload

# the ONE bench workload (st_dadk_tpu/bench_workload.py); only the tag
# deviates, so stage timings line up with the headline bench
BASE = bench_workload(tag="prof")


def t(label, t0):
    dt = time.time() - t0
    print(f"  {label:<42} {dt*1000:9.1f} ms", flush=True)
    return time.time()


def run_batch(cfg, M, exp_dir, epochs_chunk=100, label="run"):
    from st_dadk_tpu.train.batch_engine import (_batched_eval, _lane)
    from st_dadk_tpu.train.experiment import ExperimentSetup, finalize_experiment
    from st_dadk_tpu.train.loop import (LoopSpec, adaptive_batch_size,
                                        assemble_result, jitted_fit_chunk,
                                        prepare_carry_batch,
                                        prepare_train_data)
    from st_dadk_tpu.train.optimizer import build_lr_tables
    from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
    from jax.sharding import NamedSharding, PartitionSpec as P
    from st_dadk_tpu.train.batch_engine import experiment_mesh

    print(f"[{label}] M={M} chunk={epochs_chunk}")
    t_all = time.time()
    t0 = time.time()
    setups = []
    for i in range(1, M + 1):
        s = ExperimentSetup(cfg, i, verbose=False, defer_model=True)
        s.cfg = cfg
        s.out_dir = Path(exp_dir) / str(i)
        setups.append(s)
    t0 = t("setup: masks+pointsets (host)", t0)

    keys = jnp.stack([jax.random.PRNGKey(s.experiment_seed) for s in setups])
    coords_list = [s.train_ps.coords for s in setups]
    inits = init_spatial_centers_batch(cfg.spatial_init_method,
                                       cfg.k_spatial_centers, coords_list, keys)
    centers_b = jnp.asarray(np.stack([c for c, _ in inits]))
    bw_b = jnp.asarray(np.stack([b for _, b in inits]))
    jax.block_until_ready(centers_b)
    t0 = t("setup: vmapped GMM init", t0)

    spec_model = setups[0].spec
    batch_size = adaptive_batch_size(min(s.train_ps.n_real for s in setups),
                                     cfg.batch_size)
    B = max(-(-s.train_ps.n_real // batch_size) for s in setups)
    cap_tr = B * batch_size
    max_val = max(s.valid_ps.n_real for s in setups)
    val_chunk = min(max(batch_size * 16, 32768), max_val)
    nvc = max(1, -(-max_val // val_chunk))
    cap_va = nvc * val_chunk
    datas = [prepare_train_data(s.train_ps, s.valid_ps, batch_size,
                                val_chunk=val_chunk, cap_tr=cap_tr,
                                cap_va=cap_va)[0] for s in setups]
    data_b = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *datas)
    t0 = t("stack lanes (host)", t0)

    carry_b, consts_b = prepare_carry_batch(spec_model, M)(keys, centers_b, bw_b)
    jax.block_until_ready(carry_b["params"])
    t0 = t("prepare_carry_batch (device)", t0)

    consts_host = jax.tree_util.tree_map(np.asarray, consts_b)
    for i, s in enumerate(setups):
        s.consts = jax.tree_util.tree_map(lambda x, i=i: x[i], consts_host)
        s.n_params = 0
    t0 = t("consts pull (host)", t0)

    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B, val_chunk, nvc)
    import dataclasses
    if spec.record_centers and epochs_chunk % 100 == 0:
        spec = dataclasses.replace(spec, centers_every=100)
    ce = spec.centers_every
    lr_tabs = []
    for d in datas:
        lm, lb, lrec = build_lr_tables(cfg, int(d.n_batches))
        lr_tabs.append(np.stack([lm, lb], -1).reshape(cfg.epochs, -1, 2))
    lr_steps = np.stack(lr_tabs)
    t0 = t("LR tables (host)", t0)

    mesh = experiment_mesh(cfg.mesh_axis)
    sh = NamedSharding(mesh, P(cfg.mesh_axis))
    data_b = jax.device_put(data_b, sh)
    carry_b = jax.device_put(carry_b, sh)
    consts_b = jax.device_put(consts_b, sh)
    jax.block_until_ready(data_b.tr_coords)
    t0 = t("device_put lanes", t0)

    fit_chunk = jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)
    E = cfg.epochs
    chunk = epochs_chunk
    hists = []
    done = 0
    while done < E:
        c = min(chunk, E - done)
        ids = jnp.arange(done, done + c, dtype=jnp.int32)
        lr_c = jnp.asarray(lr_steps[:, done:done + c])
        active = jnp.ones((chunk,), bool)
        if c != chunk:
            pad = chunk - c
            ids = jnp.concatenate([ids, jnp.full((pad,), E - 1, jnp.int32)])
            lr_c = jnp.concatenate([lr_c, jnp.repeat(lr_c[:, -1:], pad, 1)], 1)
            active = active.at[c:].set(False)
        lr_c = jax.device_put(lr_c, sh)
        jax.block_until_ready(lr_c)
        t0 = t(f"chunk {done}: lr upload", t0)
        carry_b, hist = fit_chunk(carry_b, consts_b, data_b, ids, lr_c, active)
        jax.block_until_ready(carry_b["params"])
        t0 = t(f"chunk {done}: device scan", t0)
        hists.append({k: np.asarray(
            v[:, :c] if not (k == "centers" and ce > 1) else v[:, : c // ce])
            for k, v in hist.items()})
        t0 = t(f"chunk {done}: history pull", t0)
        done += c
        stopped = bool(np.asarray(carry_b["stopped"]).all())
        t0 = t(f"chunk {done}: stopped sync", t0)
        if stopped:
            break

    history_b = {k: np.concatenate([h[k] for h in hists], axis=1)
                 for k in hists[0]}
    from st_dadk_tpu.train.loop import pull_serving_state, select_serving_device
    from st_dadk_tpu.train.batch_engine import _batched_eval_device
    serve_host, scal_host = pull_serving_state(carry_b)
    t0 = t("serving-state pull (host)", t0)

    serve_d, _ = select_serving_device(carry_b)
    pre = _batched_eval_device(cfg, spec_model, (serve_d, consts_b), setups, M)
    t0 = t("batched eval (device metrics)", t0)

    lr_recorded = build_lr_tables(cfg, B)[2]
    for li, s in enumerate(setups):
        serve_lane = _lane(serve_host, li)
        lane_carry = {"best_ema": serve_lane, "ema": serve_lane,
                      "has_best": scal_host["has_best"][li],
                      "best_val": scal_host["best_val"][li],
                      "stopped": scal_host["stopped"][li],
                      "stop_epoch": scal_host["stop_epoch"][li]}
        lane_hist = {k: v[li] for k, v in history_b.items()}
        fr = assemble_result(spec, lane_carry, lane_hist, lr_recorded, done)
        out_dir = s.out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        r = finalize_experiment(s.cfg, s, fr, out_dir, 0.0, verbose=False,
                                precomputed=pre[li] if pre else None)
    t0 = t("finalize loop (host)", t0)
    wall = time.time() - t_all
    print(f"[{label}] total {wall:.2f}s -> {M/wall*3600:.0f} fits/hr")
    return wall


def main():
    import json
    import shutil
    import tempfile
    M = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    # ablation hook: ST_DADK_PROFILE_OVERRIDES='{"packed_optimizer": false}'
    overrides = json.loads(os.environ.get("ST_DADK_PROFILE_OVERRIDES", "{}"))
    BASE.update(overrides)
    tmp = Path(tempfile.mkdtemp(prefix="stdadk_prof_"))
    try:
        cfg = ExperimentConfig.from_dict({**BASE, "base_seed": 9999})
        run_batch(cfg, M, tmp / "warm", label="warmup(compile)")
        for rep in range(2):
            cfg = ExperimentConfig.from_dict({**BASE,
                                              "base_seed": 2025 + rep * 1000})
            run_batch(cfg, M, tmp / f"t{rep}", label=f"steady{rep}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
