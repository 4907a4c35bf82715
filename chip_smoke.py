#!/usr/bin/env python
"""Smoke run of the lane-batched DA-STDK fit on the GPU.

    python chip_smoke.py             # one card: phases 1-5 below
    python chip_smoke.py --chips 4   # four cards: phases 1-2, then a
                                     # 4-card lane mesh against a 1-card
                                     # mesh in the same process, and nothing
                                     # else

Phases (one card):
  1. device check: the first jax device must be a GPU (there is no CPU
     fallback). Prints its kind, the device count, and the cards' name and
     power limit as nvidia-smi gives them.
  2. data: the 2a_8-shaped field (S=1000 sites, T=100) generated from
     data/2b/fit_params.json into data/synth/ (git-ignored) if missing.
  3. main path: run_job_batches on 16 lanes (LANES_PER_DEVICE, one batch) of
     the bench workload (st_dadk_tpu/bench_workload.py) at its full width:
     once to compile, once timed. Prints compile seconds, the timed batch
     wall, each lane's epochs, test CRPS and RMSE, and peak device memory.
  4. plain reference: lane 0 against st_dadk_tpu/reference.py at its initial
     parameters (forward, composite loss and parameter gradients on one
     training minibatch) and at its trained parameters (forward on its test
     points), with the engine at its default matmul precision (TF32 on the
     GPU) and under "highest".
  5. TF32 end to end: the same 16 lanes with every matmul at "highest"; the
     mean test CRPS must lie within 2 sqrt(2) std / sqrt(16) of the default
     run's (two standard errors of a difference of two runs' means).

The last line of stdout is {"ok": true, "device": {...}}; a failed phase
exits non-zero before it is printed. One process drives the card(s).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

REPO = Path(__file__).resolve().parent

N_LANES = 16

# Engine at default precision: float32 matmuls may run in TF32 (10-bit
# mantissa), so predictions on the standardised target agree to ~1e-2.
TOL_DEFAULT = {"pred_abs": 2e-2, "loss_rel": 1e-2, "grad_cos": 0.999}
# Engine under "highest": both sides are float32; only summation order
# differs.
TOL_HIGHEST = {"pred_abs": 1e-4, "loss_rel": 1e-5, "grad_rel": 1e-4}

# 4-card against 1-card lane mesh (20 epochs, no early stop, every matmul
# at "highest", threefry dropout masks). The two programs are compiled for
# different per-card lane counts, so float32 sums run in another order and
# the trajectories part by rounding. Measured on 4 H100s: after the first
# epoch (16 steps) the train losses agree to <2e-7; over 320 AdamW steps
# the loss difference grows to ~1e-2 and the final parameters drift to a
# relative distance of 0.5-0.8 from the same lane's 1-card parameters,
# against 1.4 from any other lane's. So the first epoch's loss is held
# tight, the history loosely, and each lane's final parameters must be
# clearly nearer its own 1-card lane than any other lane (a lane mix-up or
# a lost lane fails all three).
TOL_MESH = {"first_epoch_loss_rel": 1e-5, "loss_rel": 2e-2,
            "param_ratio": 0.8}

def log(msg: str) -> None:
    print(msg, flush=True)


def import_package() -> None:
    """Import st_dadk_tpu from THIS checkout (and fail outside one)."""
    sys.path.insert(0, str(REPO))
    import st_dadk_tpu
    if Path(st_dadk_tpu.__file__).resolve().parent.parent != REPO:
        raise SystemExit("chip_smoke.py must run from its repository "
                         "checkout")


class CompileClock:
    """Seconds and number of XLA backend compilations since creation, and
    the programs loaded from the persistent compile cache instead."""

    EVENT = "/jax/core/compile/backend_compile_duration"
    CACHE_HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        from jax import monitoring
        self.seconds = 0.0
        self.count = 0
        self.cache_hits = 0
        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event: str, duration: float, **_: Any) -> None:
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1

    def _on_event(self, event: str, **_: Any) -> None:
        if event == self.CACHE_HIT:
            self.cache_hits += 1

    def read(self):
        return self.seconds, self.count


# -- phases -------------------------------------------------------------------

def phase_device(n_chips: int) -> Dict[str, Any]:
    from st_dadk_tpu.utils.platform import require_gpu
    dev = require_gpu(n_chips)
    log(f"[device] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    for line in str(dev["nvidia_smi"]).splitlines():
        log(f"[device] nvidia-smi name, power.limit: {line.strip()}")
    return dev


def phase_data(root: Path = REPO, shape=None, seed: Optional[int] = None
               ) -> Path:
    """Generate the training field (the 2a_8 shape by default) and report
    which CSV ingest path will read it."""
    from st_dadk_tpu.dataio import synth
    from st_dadk_tpu.dataio.native import native_available
    t0 = time.perf_counter()
    if shape is None:
        path = synth.ensure_2a8_field(root)
    else:
        T, S = shape
        path = synth.ensure_field(Path(root) / "field.csv", S, T, seed or 0)
    log(f"[data] {path} ready in {time.perf_counter() - t0:.2f}s; ingest "
        f"path: {'native C++' if native_available() else 'numpy'}")
    return path


def lane_jobs(data_file: Path, out_dir: Path, n_lanes: int = N_LANES,
              lane0: Optional[Dict[str, Any]] = None,
              **overrides: Any) -> List:
    """(cfg, experiment_id, output_dir) jobs of the bench workload; only the
    data file (and the caller's overrides) differ from it. `lane0` applies
    extra overrides to lane 0 alone."""
    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.config import ExperimentConfig
    cfg = ExperimentConfig.from_dict(
        bench_workload(data_file=str(data_file), **overrides))
    return [((cfg.replace(**lane0) if lane0 and i == 1 else cfg), i,
             Path(out_dir) / str(i)) for i in range(1, n_lanes + 1)]


def run_batch(jobs: List, mesh=None) -> List[Dict[str, Any]]:
    from st_dadk_tpu.train.batch_engine import run_job_batches
    return run_job_batches([jobs], mesh=mesh)


def _check_finite(results: List[Dict[str, Any]], what: str) -> None:
    bad = [r["experiment_id"] for r in results
           if not (math.isfinite(r["test_crps"])
                   and math.isfinite(r["test_rmse"]))]
    if bad:
        raise SystemExit(f"[{what}] non-finite test metrics in lanes {bad}")


def peak_bytes() -> Optional[int]:
    import jax
    stats = jax.local_devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def phase_main(data_file: Path, work: Path, clock: CompileClock,
               n_lanes: int = N_LANES, **overrides: Any
               ) -> List[Dict[str, Any]]:
    s0, n0 = clock.read()
    t0 = time.perf_counter()
    run_batch(lane_jobs(data_file, work / "warmup", n_lanes, **overrides))
    warm_wall = time.perf_counter() - t0
    s1, n1 = clock.read()

    t0 = time.perf_counter()
    results = run_batch(lane_jobs(data_file, work / "timed", n_lanes,
                                  **overrides))
    wall = time.perf_counter() - t0
    s2, n2 = clock.read()

    log(f"[main] compile: {s1 - s0:.1f}s in {n1 - n0} XLA compilations, "
        f"{clock.cache_hits} programs from the persistent cache (warmup "
        f"batch wall {warm_wall:.1f}s)")
    log(f"[main] timed batch: {n_lanes} lanes in {wall:.2f}s wall "
        f"({n2 - n1} compilations inside it)")
    for r in results:
        log(f"[main] lane {r['experiment_id']:2d}: epochs "
            f"{r['n_epochs_run']:3d}  test CRPS {r['test_crps']:.4f}  "
            f"test RMSE {r['test_rmse']:.4f}")
    crps = np.array([r["test_crps"] for r in results])
    rmse = np.array([r["test_rmse"] for r in results])
    log(f"[main] mean test CRPS {crps.mean():.4f} (std {crps.std(ddof=1):.4f})"
        f"  mean test RMSE {rmse.mean():.4f}")
    pb = peak_bytes()
    log(f"[main] peak_bytes_in_use: "
        f"{'not available' if pb is None else pb}")
    _check_finite(results, "main")
    return results


def _flat(tree) -> Dict[str, np.ndarray]:
    import jax
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in leaves}


def compare(ref_out, eng_out) -> Dict[str, float]:
    """Agreement of an engine evaluation with the reference's. Each side is
    a dict with 'pred' and optionally 'loss' and 'grad'."""
    out = {"pred_abs": float(np.max(np.abs(
        np.asarray(eng_out["pred"], np.float64)
        - np.asarray(ref_out["pred"], np.float64))))}
    if "loss" in ref_out:
        r, e = float(ref_out["loss"]), float(eng_out["loss"])
        out["loss_rel"] = abs(e - r) / max(abs(r), 1e-30)
        gr, ge = _flat(ref_out["grad"]), _flat(eng_out["grad"])
        rel = [np.linalg.norm(ge[k] - gr[k]) / max(np.linalg.norm(gr[k]),
                                                   1e-30) for k in gr]
        vr = np.concatenate([gr[k].ravel() for k in sorted(gr)])
        ve = np.concatenate([ge[k].ravel() for k in sorted(gr)])
        out["grad_rel"] = float(max(rel))
        out["grad_cos"] = float(vr @ ve / max(np.linalg.norm(vr)
                                              * np.linalg.norm(ve), 1e-30))
    return out


def within(measured: Dict[str, float], tol: Dict[str, float]) -> bool:
    return all((measured[k] >= v) if k == "grad_cos" else (measured[k] <= v)
               for k, v in tol.items() if k in measured)


def phase_reference(data_file: Path, work: Path, n_lanes: int = N_LANES,
                    **overrides: Any) -> Dict[str, Dict[str, float]]:
    """Lane 0 of the bench batch against the plain reference."""
    import jax
    import jax.numpy as jnp

    from st_dadk_tpu import reference as ref
    from st_dadk_tpu.models.st_interp import _dropout_masks, forward
    from st_dadk_tpu.train.experiment import ExperimentSetup, load_params_npz
    from st_dadk_tpu.train.loop import (LoopSpec, adaptive_batch_size,
                                        predict, training_loss)

    # the same batch again, with lane 0 writing its serving parameters
    jobs = lane_jobs(data_file, work / "reference", n_lanes,
                     lane0={"save_artifacts": True}, **overrides)
    run_batch(jobs)
    cfg, exp_id, lane_dir = jobs[0]
    trained = jax.tree_util.tree_map(
        jnp.asarray, load_params_npz(lane_dir / "model_final.npz"))

    # lane 0's seed-exact masks and initial parameters
    setup = ExperimentSetup(cfg, exp_id)
    spec, consts, params0 = setup.spec, setup.consts, setup.params
    ps = setup.train_ps
    bs = adaptive_batch_size(ps.n_real, cfg.batch_size)
    idx = np.random.default_rng(cfg.base_seed).permutation(ps.n_real)[:bs]
    c, t, y = (jnp.asarray(a[idx]) for a in (ps.coords, ps.t, ps.y))
    w = jnp.ones((len(idx),), jnp.float32)
    key = jax.random.PRNGKey(setup.experiment_seed)
    keep = _dropout_masks(spec, key, len(idx))
    lspec = LoopSpec.from_config(cfg, spec, bs, 1, 1, 1)
    test = setup.test_ps

    ref_init = {"pred": ref.forward(cfg, params0, consts, c, t)}
    ref_init["loss"], ref_init["grad"] = ref.loss_and_grad(
        cfg, params0, consts, c, t, y, w, keep)
    ref_trained = {"pred": ref.forward(cfg, trained, consts,
                                       jnp.asarray(test.coords),
                                       jnp.asarray(test.t))}

    def engine():
        fwd = jax.jit(lambda p: forward(spec, p, consts, None, c, t,
                                        train=False))
        vg = jax.jit(jax.value_and_grad(
            lambda p: training_loss(lspec, p, consts, c, t, y, w, True,
                                    key)))
        loss, grad = vg(params0)
        return ({"pred": fwd(params0), "loss": loss, "grad": grad},
                {"pred": predict(spec, trained, consts, test.coords,
                                 test.t)})

    report, ok = {}, True
    for prec, tol, ctx in (
            ("default", TOL_DEFAULT, contextlib.nullcontext()),
            ("highest", TOL_HIGHEST, jax.default_matmul_precision("highest"))):
        with ctx:
            eng_init, eng_trained = engine()
        for where, r_out, e_out in (("initial", ref_init, eng_init),
                                    ("trained", ref_trained, eng_trained)):
            m = compare(r_out, e_out)
            good = within(m, tol)
            ok &= good
            report[f"{where}/{prec}"] = m
            shown = "  ".join(f"{k} {m[k]:.3g} (tol {tol[k]:g})"
                              for k in tol if k in m)
            log(f"[reference] lane 0 {where} params, engine at {prec} "
                f"precision: {shown}  {'PASS' if good else 'FAIL'}")
    log(f"[reference] minibatch {len(idx)} training points; trained-params "
        f"forward on {test.n_real} test points")
    if not ok:
        raise SystemExit("[reference] engine and plain reference disagree "
                         "beyond tolerance")
    return report


@contextlib.contextmanager
def highest_precision():
    """Every matmul at "highest", set process-wide so the engine's prepare
    and finalize threads see it too (jax's context manager is per thread)."""
    import jax
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jax.config.update("jax_default_matmul_precision", before)


def phase_tf32(data_file: Path, work: Path,
               default_results: List[Dict[str, Any]],
               n_lanes: int = N_LANES, **overrides: Any) -> Dict[str, float]:
    """The same lanes with every matmul at "highest"."""
    with highest_precision():
        t0 = time.perf_counter()
        hi = run_batch(lane_jobs(data_file, work / "highest", n_lanes,
                                 **overrides))
        wall = time.perf_counter() - t0
    _check_finite(hi, "tf32")
    log("[tf32] per-lane test CRPS under highest: " + " ".join(
        f"{r['test_crps']:.4f}" for r in hi))
    d = np.array([r["test_crps"] for r in default_results])
    h = np.array([r["test_crps"] for r in hi])
    one_run = 2.0 * d.std(ddof=1) / math.sqrt(len(d))
    # The two runs share seeds but not rounding, and a fit's trajectory
    # amplifies rounding, so each run is a separate draw from the lanes'
    # seed spread: their difference of means has sqrt(2) times one run's
    # standard error. The bound is 2 standard errors of that difference.
    bound = math.sqrt(2.0) * one_run
    diff = float(h.mean() - d.mean())
    log(f"[tf32] mean test CRPS: default {d.mean():.5f}, highest "
        f"{h.mean():.5f}, difference {diff:+.5f}; bound 2*sqrt(2)*std/"
        f"sqrt({len(d)}) = {bound:.5f} (2*std/sqrt({len(d)}) = {one_run:.5f})"
        f"; highest batch wall {wall:.1f}s incl. compile")
    if abs(diff) > bound:
        raise SystemExit("[tf32] default-precision CRPS differs from "
                         "'highest' by more than the seed spread bound")
    return {"default": float(d.mean()), "highest": float(h.mean()),
            "diff": diff, "bound": float(bound)}


def phase_four_cards(data_file: Path, work: Path, n_lanes: int = N_LANES,
                     epochs: int = 20, **overrides: Any) -> List[Dict]:
    """The same lanes on a 4-card 'exp' mesh (n_lanes/4 per card) and on a
    1-card mesh, with no early stop and every matmul at "highest";
    per-lane train-loss histories and final parameters must agree (see
    TOL_MESH).

    Dropout masks come from threefry here, whose mask is a function of the
    lane's own key alone. Under vmap jax draws every lane's 'rbg' bits from
    the batch's FIRST lane key, so a lane's 'rbg' masks depend on its batch
    mates (on the H100 they came out the same on both meshes, but XLA does
    not promise that)."""
    import jax
    from jax.sharding import Mesh

    from st_dadk_tpu.train.experiment import load_params_npz

    devs = jax.devices()
    meshes = {"4-card": Mesh(np.array(devs[:4]), ("exp",)),
              "1-card": Mesh(np.array(devs[:1]), ("exp",))}
    ov = dict(overrides, epochs=epochs, patience=epochs + 1000,
              save_artifacts=True, dropout_rng="threefry")
    runs = {}
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        with highest_precision():
            runs[name] = (run_batch(lane_jobs(data_file, work / name,
                                              n_lanes, **ov), mesh=mesh),
                          work / name)
        log(f"[mesh] {name}: {n_lanes} lanes x {epochs} epochs in "
            f"{time.perf_counter() - t0:.1f}s (incl. compile)")
    (r4, d4), (r1, d1) = runs["4-card"], runs["1-card"]
    hist, params = {}, {}
    for name, res, d in (("4", r4, d4), ("1", r1, d1)):
        for r in res:
            i = r["experiment_id"]
            hist[name, i] = np.array(r["training_history"]["train_loss"])
            if len(hist[name, i]) != epochs:
                raise SystemExit(f"[mesh] lane {i} stopped early "
                                 f"({len(hist[name, i])} epochs)")
            params[name, i] = _flat(load_params_npz(
                d / str(i) / "model_final.npz"))

    def param_dist(a, b):
        """Largest relative Frobenius distance over the parameter leaves."""
        return max(float(np.linalg.norm(a[k] - b[k])
                         / max(np.linalg.norm(b[k]), 1e-30)) for k in b)

    lanes = [r["experiment_id"] for r in r1]
    rows, ok = [], True
    for i in lanes:
        la, lb = hist["4", i], hist["1", i]
        first = float(abs(la[0] - lb[0]) / abs(lb[0]))
        loss_rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
        own = param_dist(params["4", i], params["1", i])
        other = min(param_dist(params["4", i], params["1", j])
                    for j in lanes if j != i)
        ratio = own / other
        good = (first <= TOL_MESH["first_epoch_loss_rel"]
                and loss_rel <= TOL_MESH["loss_rel"]
                and ratio <= TOL_MESH["param_ratio"])
        ok &= good
        rows.append({"lane": i, "first_epoch_loss_rel": first,
                     "loss_rel": loss_rel, "param_dist": own,
                     "param_dist_other": other, "param_ratio": ratio})
        log(f"[mesh] lane {i:2d}: train loss rel diff epoch 1 {first:.3g} "
            f"(tol {TOL_MESH['first_epoch_loss_rel']:g}), max {loss_rel:.3g}"
            f" (tol {TOL_MESH['loss_rel']:g}); final params rel distance "
            f"{own:.3g}, nearest other lane {other:.3g}, ratio {ratio:.3g} "
            f"(tol {TOL_MESH['param_ratio']:g})  {'PASS' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("[mesh] 4-card and 1-card lanes disagree")
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-card against 1-card lane mesh "
                         "comparison")
    args = ap.parse_args(argv)

    import_package()
    dev = phase_device(args.chips)

    import jax
    from st_dadk_tpu.utils.platform import enable_compile_cache
    log(f"[setup] jax {jax.__version__}; compile cache "
        f"{enable_compile_cache()}")
    clock = CompileClock()
    data_file = phase_data()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if args.chips == 4:
            phase_four_cards(data_file, work)
        else:
            default_results = phase_main(data_file, work, clock)
            phase_reference(data_file, work)
            phase_tf32(data_file, work, default_results)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {clock.count} XLA compilations, {clock.seconds:.1f}s "
        f"compiling in all; {clock.cache_hits} programs from the persistent "
        f"cache")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
