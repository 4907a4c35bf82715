#!/usr/bin/env python
"""Drift-controlled throughput A/B: interleave two configs batch-by-batch.

A card's throughput drifts between runs (clocks under a power limit,
neighbours on the host), so comparing two separate bench runs cannot
resolve effects of a few per cent. This harness removes the drift term:
after warming BOTH compiled programs, it alternates a-batch / b-batch in
one process (a,b,a,b,...) and compares per-batch walls PAIRWISE, so slow
phases hit both arms equally. Reports the paired wall ratio with a sign-test-style spread.

Usage:
    python scripts/ab_interleaved.py --b train_dtype=bf16 scan_unroll=4 \
        [--a key=val ...] [--pairs 12] [--m 16] [--out results/dir]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", nargs="*", default=[],
                    help="arm-a overrides (default: bare bench workload)")
    ap.add_argument("--b", nargs="+", required=True,
                    help="arm-b overrides, key=val")
    ap.add_argument("--pairs", type=int, default=12,
                    help="interleaved (a,b) batch pairs to time")
    ap.add_argument("--m", type=int, default=16, help="lanes per batch")
    ap.add_argument("--m_b", type=int, default=None,
                    help="lanes per batch for arm b (default: same as --m)."
                         " When arms differ, walls are normalized per fit"
                         " before pairing, so the ratio compares THROUGHPUT"
                         " (e.g. --m 16 --m_b 32 asks whether 32 wide lanes"
                         " beat two 16-lane batches per fit)")
    ap.add_argument("--out", default=None,
                    help="write summary json under this dir")
    ap.add_argument("--stream", type=int, default=0,
                    help="N>0: each timed rep is a PIPELINED stream of N "
                         "batches (run_job_batches) instead of one "
                         "sequential batch — required for knobs whose "
                         "effect is overlap between consecutive batches "
                         "(e.g. final_stop_sync); walls normalize per fit")
    args = ap.parse_args()

    import numpy as np

    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.config import ExperimentConfig
    from st_dadk_tpu.train.batch_engine import run_job_batch, run_job_batches

    arms = {"a": bench_workload(**parse_kv(args.a)),
            "b": bench_workload(**parse_kv(args.b))}
    print(f"arm a overrides: {parse_kv(args.a) or '(bare workload)'}")
    print(f"arm b overrides: {parse_kv(args.b)}")

    tmp = Path(tempfile.mkdtemp(prefix="ab_interleaved_"))

    m_arm = {"a": args.m, "b": args.m_b or args.m}

    def batch(arm: str, seed: int):
        M = m_arm[arm]
        if args.stream:
            batches = []
            for bi in range(args.stream):
                cfg = ExperimentConfig.from_dict(
                    {**arms[arm], "base_seed": seed + bi * 131})
                batches.append([(cfg, i, tmp / arm / f"{seed}_{bi}" / str(i))
                                for i in range(1, M + 1)])
            t0 = time.time()
            res = run_job_batches(batches, epochs_chunk=500)
            return time.time() - t0, res
        cfg = ExperimentConfig.from_dict({**arms[arm], "base_seed": seed})
        jobs = [(cfg, i, tmp / arm / str(seed) / str(i))
                for i in range(1, M + 1)]
        t0 = time.time()
        res = run_job_batch(jobs, epochs_chunk=500)
        return time.time() - t0, res

    # warm both programs (compile + first-run costs), order a,b,a,b so any
    # residual warmup asymmetry is shared
    for arm in ("a", "b", "a", "b"):
        w, _ = batch(arm, 777)
        print(f"  warmup {arm}: {w:.1f}s")

    walls = {"a": [], "b": []}
    crps = {"a": [], "b": []}
    for p in range(args.pairs):
        for arm in ("a", "b") if p % 2 == 0 else ("b", "a"):
            w, res = batch(arm, 1000 + p)
            walls[arm].append(w)
            crps[arm].extend(r["test_crps"] for r in res)
        ra, rb = walls["a"][-1], walls["b"][-1]
        print(f"  pair {p}: a={ra:.2f}s b={rb:.2f}s "
              f"b/a={(rb / m_arm['b']) / (ra / m_arm['a']):.3f}")

    wa, wb = np.asarray(walls["a"]), np.asarray(walls["b"])
    # per-fit normalization makes the ratio a throughput comparison when
    # the arms run different lane widths (m_b); identical to wb/wa otherwise
    ratios = (wb / m_arm["b"]) / (wa / m_arm["a"])
    med = float(np.median(ratios))
    lo, hi = (float(np.percentile(ratios, q)) for q in (10, 90))
    b_faster = int((ratios < 1.0).sum())
    fits_rep = {k: m_arm[k] * max(args.stream, 1) for k in m_arm}
    summary = {
        "m": args.m, "m_b": m_arm["b"], "pairs": args.pairs,
        "stream": args.stream,
        "a_overrides": parse_kv(args.a), "b_overrides": parse_kv(args.b),
        "wall_a": [round(float(x), 3) for x in wa],
        "wall_b": [round(float(x), 3) for x in wb],
        "ratio_median": round(med, 4),
        "ratio_p10_p90": [round(lo, 4), round(hi, 4)],
        "b_faster_count": b_faster,
        "crps_a_mean": round(float(np.mean(crps["a"])), 4),
        "crps_b_mean": round(float(np.mean(crps["b"])), 4),
        "fits_per_hour_a": round(fits_rep["a"] / float(np.median(wa)) * 3600,
                                 1),
        "fits_per_hour_b": round(fits_rep["b"] / float(np.median(wb)) * 3600,
                                 1),
    }
    print(f"\npaired wall ratio b/a: median {med:.3f} "
          f"(p10-p90 {lo:.3f}-{hi:.3f}); b faster in "
          f"{b_faster}/{args.pairs} pairs")
    mode = (f"pipelined x{args.stream} stream" if args.stream
            else "unpipelined")
    print(f"{mode} fits/hr: a {summary['fits_per_hour_a']:,} "
          f"b {summary['fits_per_hour_b']:,}")
    print(f"CRPS: a {summary['crps_a_mean']} b {summary['crps_b_mean']}")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "interleaved_summary.json").write_text(
            json.dumps(summary, indent=2))
        print(f"[OK] wrote {out / 'interleaved_summary.json'}")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
