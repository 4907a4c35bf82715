#!/usr/bin/env python
"""Scaling-regime study: where do the memory-traffic levers (bf16 trunk,
remat) flip from neutral/negative to winning as the MODEL grows?

Both knobs' costs/savings scale with activation bytes, so each has a
predicted crossover as hidden_dims / k grow. This harness maps
it: for a grid of model sizes it builds the SAME 100-epoch vmapped
fit-chunk program used by ab_scan_lanes (one st_dadk engine batch, M lanes
of the 2a_8 workload) under arms {f32, bf16, remat, bf16+remat}, times the
arms pairwise-interleaved in one process (drift-controlled), and reports
paired wall ratios vs the f32 arm per size.

The output is a regime table — the evidence base for when a user (or a
future auto policy, like train_dtype='auto' for lane width) should flip
these opt-ins at larger-than-reference models.

Usage:
    python scripts/bench_scaling_regimes.py [--pairs 8] [--m 8]
        [--epochs-chunk 100] [--sizes ref mlp4x mlp4x_k4x mlp8x_k4x]
        [--out results/scaling_regimes_r4]
"""
from __future__ import annotations

import argparse
import importlib.util
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



def _load_scan_harness():
    spec = importlib.util.spec_from_file_location(
        "ab_scan_lanes", REPO / "scripts" / "ab_scan_lanes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Model-size grid. Sizes change SHAPES (hidden_dims / k), so each size is
# its own base config; variant arms (dtype/remat) never change shapes and
# compare WITHIN a size. Big-k sizes use the uniform grid init (32^2) so
# arm-build cost stays bounded; the timed scan program is init-agnostic.
SIZES = {
    "ref": {},
    "mlp2x": {"hidden_dims": [512, 512, 256]},
    "mlp4x": {"hidden_dims": [1024, 1024, 512]},
    "mlp4x_k4x": {"hidden_dims": [1024, 1024, 512],
                  "k_spatial_centers": [1024],
                  "spatial_init_method": "uniform"},
    "mlp8x_k4x": {"hidden_dims": [2048, 2048, 1024],
                  "k_spatial_centers": [1024],
                  "spatial_init_method": "uniform"},
}

ARMS = {
    "f32": {},
    "bf16": {"train_dtype": "bf16"},
    "remat": {"remat": True},
    "bf16_remat": {"train_dtype": "bf16", "remat": True},
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--m", type=int, default=8, help="lanes per arm")
    ap.add_argument("--epochs-chunk", type=int, default=100)
    ap.add_argument("--sizes", nargs="+", default=list(SIZES),
                    choices=list(SIZES))
    ap.add_argument("--arms", nargs="+", default=list(ARMS),
                    choices=list(ARMS))
    ap.add_argument("--out", default="results/scaling_regimes_r4")
    args = ap.parse_args()

    import jax
    import numpy as np

    from st_dadk_tpu.bench_workload import bench_workload

    harness = _load_scan_harness()
    chunk = args.epochs_chunk
    M = args.m

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # staged runs (--sizes subsets) merge into one report
    if (out / "report.json").exists():
        report = json.loads((out / "report.json").read_text())
        report.update(m=M, epochs_chunk=chunk, pairs=args.pairs)
    else:
        report = {"m": M, "epochs_chunk": chunk, "pairs": args.pairs,
                  "sizes": {}}

    for size in args.sizes:
        base = bench_workload(**SIZES[size])
        arms = {}
        for arm in args.arms:
            t0 = time.time()
            arms[arm] = harness.build_scan_arm(base, ARMS[arm], M, chunk)
            print(f"[build] {size}/{arm}: {time.time() - t0:.1f}s",
                  flush=True)

        def run(arm: str) -> float:
            a = arms[arm]
            carry_in = jax.device_put(a["carry_host"], a["sh"])
            jax.block_until_ready(carry_in["params"])
            t0 = time.time()
            new_carry, hist = a["fit"](carry_in, a["consts_b"], a["data_b"],
                                       a["ids"], a["lr_c"], a["active"])
            jax.block_until_ready((new_carry["params"], hist["train_loss"]))
            return time.time() - t0

        names = list(arms)
        for nm in names + names:
            print(f"  warmup {size}/{nm}: {run(nm):.2f}s", flush=True)
        walls = {nm: [] for nm in names}
        for p in range(args.pairs):
            order = names if p % 2 == 0 else names[::-1]
            for nm in order:
                walls[nm].append(run(nm))
            print("  pair %d: %s" % (p, "  ".join(
                f"{nm}={walls[nm][-1]:.3f}s" for nm in names)), flush=True)

        entry = {"base_overrides": SIZES[size],
                 "walls": {nm: [round(float(x), 4) for x in walls[nm]]
                           for nm in names}}
        f32w = np.asarray(walls["f32"])
        print(f"[{size}] f32 median {np.median(f32w):.3f}s")
        for nm in names:
            if nm == "f32":
                continue
            r = np.asarray(walls[nm]) / f32w
            entry[f"ratio_{nm}"] = round(float(np.median(r)), 4)
            entry[f"ratio_{nm}_p10_p90"] = [round(float(np.percentile(r, q)),
                                                  4) for q in (10, 90)]
            print(f"[{size}] {nm}: paired ratio "
                  f"{entry[f'ratio_{nm}']:.3f} "
                  f"(p10-p90 {entry[f'ratio_{nm}_p10_p90']})", flush=True)
        report["sizes"][size] = entry
        # free the arms' device buffers before the next (bigger) size
        del arms
        (out / "report.json").write_text(json.dumps(report, indent=2))

    print(f"[OK] wrote {out / 'report.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
