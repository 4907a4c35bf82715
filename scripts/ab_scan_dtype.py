#!/usr/bin/env python
"""Paired timing of the EPOCH-SCAN program alone across config variants.

Whole-fit timings mix many programs; this harness isolates the one
compiled program that matters — the 100-epoch vmapped fit chunk — and
times variants back-to-back on the SAME lane batch (same data, same initial
carry), so the comparison has no init/eval/finalize/trajectory term and no
session-drift term. Optionally dumps each variant's optimized HLO for
fusion-level diffing.

Usage:
    python scripts/ab_scan_dtype.py --variants f32= bf16=train_dtype=bf16 \
        [--pairs 10] [--m 16] [--epochs-chunk 100] [--dump-hlo /tmp/hlo]
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


def parse_variant(s: str):
    """'name=key=val,key=val' -> (name, overrides dict)."""
    name, _, rest = s.partition("=")
    out = {}
    if rest:
        for kv in rest.split(","):
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            out[k] = v
    return name, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", required=True,
                    help="name=key=val,key=val ... (empty overrides = bare)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--epochs-chunk", type=int, default=100)
    ap.add_argument("--dump-hlo", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.models.st_interp import spec_from_config
    from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
    from st_dadk_tpu.train.batch_engine import experiment_mesh
    from st_dadk_tpu.train.experiment import ExperimentSetup
    from st_dadk_tpu.train.loop import (LoopSpec, adaptive_batch_size,
                                        jitted_fit_chunk, prepare_carry_batch,
                                        prepare_train_data)
    from st_dadk_tpu.train.optimizer import build_lr_tables

    variants = [parse_variant(v) for v in args.variants]
    M, chunk = args.m, args.epochs_chunk
    base = bench_workload()

    # one shared lane batch (masks/inits/data identical across variants)
    cfg0 = ExperimentConfig.from_dict({**base, "base_seed": 2025})
    tmp = Path(tempfile.mkdtemp(prefix="ab_scan_"))
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

    progs = {}
    for name, ov in variants:
        cfg = ExperimentConfig.from_dict({**base, **ov, "base_seed": 2025})
        spec_model = spec_from_config(cfg)
        spec = LoopSpec.from_config(cfg, spec_model, batch_size, B,
                                    val_chunk, nvc)
        spec = dataclasses.replace(spec, centers_every=100)
        carry_b, consts_b = prepare_carry_batch(spec_model, M)(
            keys, centers_b, bw_b)
        carry_host = jax.tree_util.tree_map(np.asarray, carry_b)
        carry_b = jax.device_put(carry_b, sh)
        consts_b = jax.device_put(consts_b, sh)
        fit = jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)
        progs[name] = (fit, carry_host, consts_b)

        if args.dump_hlo:
            hdir = Path(args.dump_hlo)
            hdir.mkdir(parents=True, exist_ok=True)
            lowered = fit.lower(carry_b, consts_b, data_b, ids, lr_c, active)
            compiled = lowered.compile()
            (hdir / f"{name}.hlo.txt").write_text(
                compiled.as_text())
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            (hdir / f"{name}.cost.json").write_text(
                json.dumps({k: float(v) for k, v in ca.items()
                            if np.isscalar(v)}, indent=2))
            print(f"[hlo] {name}: flops={ca.get('flops', 0):.3e} "
                  f"bytes={ca.get('bytes accessed', 0):.3e}")

    def run(name: str) -> float:
        fit, carry_host, consts_b = progs[name]
        # fit_chunk donates the carry (loop.py jitted_fit_chunk
        # donate_argnums=(0,)) — re-place a fresh copy per call, outside the
        # timed region
        carry_in = jax.device_put(carry_host, sh)
        jax.block_until_ready(carry_in["params"])
        t0 = time.time()
        new_carry, hist = fit(carry_in, consts_b, data_b, ids, lr_c, active)
        jax.block_until_ready((new_carry["params"], hist["train_loss"]))
        return time.time() - t0

    names = [n for n, _ in variants]
    for n in names + names:   # warm twice each
        w = run(n)
        print(f"  warmup {n}: {w:.2f}s", flush=True)

    walls = {n: [] for n in names}
    for p in range(args.pairs):
        order = names if p % 2 == 0 else names[::-1]
        for n in order:
            walls[n].append(run(n))
        print("  pair %d: %s" % (p, "  ".join(
            f"{n}={walls[n][-1]:.3f}s" for n in names)), flush=True)

    ref = names[0]
    summary = {"m": M, "epochs_chunk": chunk, "pairs": args.pairs,
               "variants": {n: dict(ov) for n, ov in variants},
               "walls": {n: [round(float(x), 4) for x in walls[n]]
                         for n in names}}
    print()
    for n in names:
        med = float(np.median(walls[n]))
        r = float(np.median(np.asarray(walls[n]) / np.asarray(walls[ref])))
        summary[f"median_{n}"] = round(med, 4)
        summary[f"ratio_{n}_over_{ref}"] = round(r, 4)
        print(f"{n:>12}: median {med:.3f}s  paired ratio vs {ref}: {r:.3f}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "scan_dtype_summary.json").write_text(
            json.dumps(summary, indent=2))
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
