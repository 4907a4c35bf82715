#!/usr/bin/env python
"""Lane-count scaling attribution for the training scan.

Wider lane batches can cost superlinearly per fit, which the auto-split
policy (LANES_PER_DEVICE) works around. This harness isolates WHERE a
superlinear term lives: it builds the 100-epoch vmapped fit-chunk program at
several lane counts (same bench workload, shared seeds/masks per lane id),
times them PAIRWISE-interleaved in one process (drift-controlled, same
method as ab_scan_dtype), and reports wall, wall/lane, and the M->2M scaling
exponent. `--b key=val` applies config overrides to EVERY arm, so ablations
(dropout=0, pregather off, rbg vs threefry masks, ...) show whether a
component is responsible for the superlinear scaling.

Usage:
    python scripts/ab_scan_lanes.py --lanes 8 16 32 [--b dropout=0.0 ...]
        [--pairs 10] [--epochs-chunk 100] [--dump-hlo results/hlo_lanes]
        [--out results/ab_scan_lanes_r4]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from st_dadk_tpu.utils.platform import (apply_platform_env,  # noqa: E402
                                        enable_compile_cache)

apply_platform_env()
enable_compile_cache()



def parse_kv(items):
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def build_scan_arm(base: dict, overrides: dict, M: int, chunk: int):
    """Compile the M-lane fit-chunk program; returns (fit, carry_host,
    consts_b, data_b, ids, lr_c, active, sh, compiled)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.models.st_interp import spec_from_config
    from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
    from st_dadk_tpu.train.batch_engine import experiment_mesh
    from st_dadk_tpu.train.experiment import ExperimentSetup
    from st_dadk_tpu.train.loop import (LoopSpec, adaptive_batch_size,
                                        jitted_fit_chunk, prepare_carry_batch,
                                        prepare_train_data)
    from st_dadk_tpu.train.optimizer import build_lr_tables

    cfg0 = ExperimentConfig.from_dict({**base, "base_seed": 2025})
    tmp = Path(tempfile.mkdtemp(prefix="ab_lanes_"))
    setups = []
    for i in range(1, M + 1):
        s = ExperimentSetup(cfg0, i, verbose=False, defer_model=True)
        s.out_dir = tmp / str(i)
        setups.append(s)
    keys = jnp.stack([jax.random.PRNGKey(s.experiment_seed) for s in setups])
    inits = init_spatial_centers_batch(
        cfg0.spatial_init_method, cfg0.k_spatial_centers,
        [s.train_ps.coords for s in setups], keys)
    centers_b = jnp.asarray(np.stack([c for c, _ in inits]))
    bw_b = jnp.asarray(np.stack([b for _, b in inits]))

    batch_size = adaptive_batch_size(min(s.train_ps.n_real for s in setups),
                                     cfg0.batch_size)
    B = max(-(-s.train_ps.n_real // batch_size) for s in setups)
    cap_tr = B * batch_size
    max_val = max(s.valid_ps.n_real for s in setups)
    val_chunk = min(max(batch_size * 16, 32768), max_val)
    nvc = max(1, -(-max_val // val_chunk))
    datas = [prepare_train_data(s.train_ps, s.valid_ps, batch_size,
                                val_chunk=val_chunk, cap_tr=cap_tr,
                                cap_va=nvc * val_chunk)[0] for s in setups]
    data_b = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *datas)

    mesh = experiment_mesh(cfg0.mesh_axis)
    sh = NamedSharding(mesh, P(cfg0.mesh_axis))
    data_b = jax.device_put(data_b, sh)

    lr_tabs = []
    for d in datas:
        lm, lb, _ = build_lr_tables(cfg0, int(d.n_batches))
        lr_tabs.append(np.stack([lm, lb], -1).reshape(cfg0.epochs, -1, 2))
    lr_steps = np.stack(lr_tabs)
    ids = jnp.arange(0, chunk, dtype=jnp.int32)
    lr_c = jax.device_put(jnp.asarray(lr_steps[:, :chunk]), sh)
    active = jnp.ones((chunk,), bool)

    cfg = ExperimentConfig.from_dict({**base, **overrides,
                                      "base_seed": 2025})
    spec_model = spec_from_config(cfg)
    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B,
                                val_chunk, nvc)
    spec = dataclasses.replace(spec, centers_every=chunk)
    carry_b, consts_b = prepare_carry_batch(spec_model, M)(
        keys, centers_b, bw_b)
    carry_host = jax.tree_util.tree_map(np.asarray, carry_b)
    carry_b = jax.device_put(carry_b, sh)
    consts_b = jax.device_put(consts_b, sh)
    fit = jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)
    compiled = fit.lower(carry_b, consts_b, data_b, ids, lr_c,
                         active).compile()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(fit=fit, carry_host=carry_host, consts_b=consts_b,
                data_b=data_b, ids=ids, lr_c=lr_c, active=active, sh=sh,
                compiled=compiled)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--b", nargs="*", default=[],
                    help="config overrides applied to ALL arms (ablation)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--epochs-chunk", type=int, default=100)
    ap.add_argument("--dump-hlo", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import numpy as np

    from st_dadk_tpu.bench_workload import bench_workload

    overrides = parse_kv(args.b)
    base = bench_workload()
    chunk = args.epochs_chunk

    arms = {}
    for M in args.lanes:
        print(f"[build] M={M} ...", flush=True)
        arms[M] = build_scan_arm(base, overrides, M, chunk)
        if args.dump_hlo:
            hdir = Path(args.dump_hlo)
            hdir.mkdir(parents=True, exist_ok=True)
            compiled = arms[M]["compiled"]
            (hdir / f"m{M}.hlo.txt").write_text(compiled.as_text())
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            (hdir / f"m{M}.cost.json").write_text(
                json.dumps({k: float(v) for k, v in ca.items()
                            if np.isscalar(v)}, indent=2))
            print(f"[hlo] M={M}: flops={ca.get('flops', 0):.3e} "
                  f"bytes={ca.get('bytes accessed', 0):.3e}")

    def run(M: int) -> float:
        a = arms[M]
        carry_in = jax.device_put(a["carry_host"], a["sh"])
        jax.block_until_ready(carry_in["params"])
        t0 = time.time()
        new_carry, hist = a["fit"](carry_in, a["consts_b"], a["data_b"],
                                   a["ids"], a["lr_c"], a["active"])
        jax.block_until_ready((new_carry["params"], hist["train_loss"]))
        return time.time() - t0

    Ms = list(args.lanes)
    for M in Ms + Ms:
        w = run(M)
        print(f"  warmup M={M}: {w:.2f}s", flush=True)

    walls = {M: [] for M in Ms}
    for p in range(args.pairs):
        order = Ms if p % 2 == 0 else Ms[::-1]
        for M in order:
            walls[M].append(run(M))
        print("  pair %d: %s" % (p, "  ".join(
            f"M{M}={walls[M][-1]:.3f}s" for M in Ms)), flush=True)

    summary = {"lanes": Ms, "epochs_chunk": chunk, "pairs": args.pairs,
               "overrides": overrides,
               "walls": {str(M): [round(float(x), 4) for x in walls[M]]
                         for M in Ms}}
    print()
    meds = {}
    for M in Ms:
        meds[M] = float(np.median(walls[M]))
        summary[f"median_m{M}"] = round(meds[M], 4)
        summary[f"per_lane_m{M}"] = round(meds[M] / M, 5)
        print(f"M={M:>3}: median {meds[M]:.3f}s  per-lane "
              f"{meds[M] / M * 1000:.1f}ms")
    for a, b in zip(Ms, Ms[1:]):
        if b == 2 * a:
            # paired doubling ratio (per pair, robust to drift)
            r = float(np.median(np.asarray(walls[b]) / np.asarray(walls[a])))
            summary[f"double_ratio_{a}to{b}"] = round(r, 4)
            print(f"  {a}->{b} lanes: paired wall ratio {r:.3f} "
                  f"(linear would be 2.0; <2 = superlinear THROUGHPUT win)")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "scan_lanes_summary.json").write_text(
            json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
