"""Vmapped, mesh-sharded experiment batches — the joblib replacement.

The reference parallelizes experiment repeats with a process pool
(train_st_interp.py:2945-2991) and grid-search configs with an outer pool
(run_grid_search.py:331-387). Here the M repeats of one config become a
leading batch axis: per-experiment params/consts/data are stacked, the whole
epoch scan is `jax.vmap`-ed, and the stacked inputs are placed with a
`NamedSharding` over the 'exp' axis of a `jax.sharding.Mesh` — XLA SPMD then
splits the lanes across devices with zero steady-state collectives
(experiments are embarrassingly parallel; see SURVEY.md section 2.4).

Per-lane semantics are preserved exactly: each lane keeps its own seed-derived
masks, its own real batch count (surplus steps are masked), its own EMA decay,
early stopping, and best-checkpoint tracking.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.train.experiment import ExperimentSetup, finalize_experiment
from st_dadk_tpu.train.loop import (
    FitResult,
    LoopSpec,
    adaptive_batch_size,
    assemble_result,
    jitted_fit_chunk,
    prepare_carry_batch,
    prepare_train_data,
)
from st_dadk_tpu.train.optimizer import build_lr_tables


def _lane(tree: Any, i: int):
    return jax.tree_util.tree_map(lambda x: np.asarray(x[i]), tree)


def _eval_group_key(cfg_lane):
    """Lanes may be evaluated together only when they share the ACTUAL
    dataset and target scaling: data_file alone misgroups lanes that differ
    in data_root (resolve_data_file combines both) or normalize_target
    (different z_full scaling) — all three are stackable fields."""
    return (str(cfg_lane.resolve_data_file()),
            bool(getattr(cfg_lane, "normalize_target", True)))


def _batched_eval(cfg, spec_model, params_sel, consts_host, setups, M):
    """Per-lane split metrics + dense (T, S) field from vmapped predicts.

    `params_sel` is the host-side serving-param tree (best-EMA/EMA already
    selected on device by loop.pull_serving_state). Runs one (M_group, T*S, Q)
    inference per distinct dataset (lanes of a stacked config batch may span
    data files; every group reuses the same compiled program since shapes
    match)."""
    from st_dadk_tpu.dataio.arrays import dense_grid_points
    from st_dadk_tpu.train.experiment import metrics_from_preds
    from st_dadk_tpu.train.loop import predict_lanes

    groups: Dict[Any, List[int]] = {}
    for li, s in enumerate(setups):
        groups.setdefault(_eval_group_key(getattr(s, "cfg", cfg)),
                          []).append(li)

    median_idx = (len(cfg.quantile_levels) // 2
                  if cfg.regression_type == "multi-quantile" else 0)

    out: List[Optional[Dict[str, Any]]] = [None] * len(setups)
    for lanes in groups.values():
        s0 = setups[lanes[0]]
        T = s0.T
        coords_rep, t_rep = dense_grid_points(T, s0.coords)
        take = lambda t: jax.tree_util.tree_map(
            lambda x: jnp.asarray(x[np.asarray(lanes)]), t)
        preds = predict_lanes(spec_model, take(params_sel),
                              take(consts_host), coords_rep, t_rep)
        for gi, li in enumerate(lanes):
            s = setups[li]
            field = preds[gi].reshape(T, s.S, -1)
            lane = {"all_predictions": field[:, :, median_idx]}
            for split, mask in (("train_metrics", s.train_mask),
                                ("val_metrics", s.valid_mask),
                                ("test_metrics", s.test_mask)):
                m = mask & np.isfinite(s.z_full)
                lane[split] = metrics_from_preds(
                    getattr(s, "cfg", cfg), field[m], s.z_full[m][:, None])
            out[li] = lane
    return out


_DEV_EVAL_CACHE: Dict[Any, Any] = {}


def _device_metrics_program(spec_model, qlevels, regression, n_chunks, n,
                            chunk):
    """vmapped all-device eval: dense predict + per-split weighted metrics.
    Returns (M, 3, K) metric rows; only those scalars reach the host."""
    from st_dadk_tpu.train.loop import _predict_chunked_raw

    key = (spec_model, tuple(qlevels or ()), regression, n_chunks, n, chunk)
    fn = _DEV_EVAL_CACHE.get(key)
    if fn is not None:
        return fn

    multi = regression == "multi-quantile"
    median_idx = len(qlevels) // 2 if multi else 0
    q = jnp.asarray(qlevels, jnp.float32) if qlevels else None

    def one(params, consts, coords_p, t_p, z, labels, tau):
        # labels: (n,) int8 — 1 train / 2 valid / 3 test (disjoint splits);
        # z is shared across the group's lanes (same dataset)
        preds = _predict_chunked_raw(spec_model, params, consts,
                                     coords_p, t_p, n_chunks)[:n]
        finite = jnp.isfinite(z)
        zz = jnp.where(finite, z, 0.0)
        pm = preds[:, median_idx]
        err = pm - zz
        if multi:
            e_k = zz[:, None] - preds                      # (n, Q)
            rho = jnp.maximum((q - 1.0) * e_k, q * e_k)
        elif regression == "quantile":
            e1 = zz - preds[:, 0]
            rho1 = jnp.maximum((tau - 1.0) * e1, tau * e1)

        def split(si):
            w = ((labels == si) & finite).astype(jnp.float32)
            cnt = jnp.maximum(jnp.sum(w), 1.0)
            mse = jnp.sum(w * err * err) / cnt
            mae = jnp.sum(w * jnp.abs(err)) / cnt
            row = [mse, mae]
            if multi:
                checks = jnp.sum(w[:, None] * rho, axis=0) / cnt   # (Q,)
                row += [2.0 * jnp.mean(checks), jnp.mean(checks)]
            elif regression == "quantile":
                row += [jnp.sum(w * rho1) / cnt]
            return jnp.stack(row)

        return jnp.stack([split(1), split(2), split(3)])   # (3, K)

    fn = jax.jit(jax.vmap(one, in_axes=(0, 0, None, None, None, 0, 0)))
    _DEV_EVAL_CACHE[key] = fn
    return fn


_EVAL_GRID_CACHE: Dict[Any, Any] = {}


def _batched_eval_device(cfg, spec_model, serve_d, setups, M):
    """All-device evaluation path: nothing but (M, 3, K) metric scalars reach
    the host (no dense-field pull, no host CRPS loops). Valid when no lane
    needs the dense prediction field (save_artifacts/save_plots off and not
    the per-tau quantile mode)."""
    from st_dadk_tpu.dataio.arrays import dense_grid_points, round_up

    serve_params, consts_d = serve_d

    groups: Dict[Any, List[int]] = {}
    for li, s in enumerate(setups):
        groups.setdefault(_eval_group_key(getattr(s, "cfg", cfg)),
                          []).append(li)

    out: List[Optional[Dict[str, Any]]] = [None] * len(setups)
    chunk = 32768
    for key, lanes in groups.items():
        s0 = setups[lanes[0]]
        T = s0.T
        # the dense eval grid + truth field are identical for every batch of
        # the same dataset — cache their device copies so a long batch
        # stream uploads them once instead of ~3 MB per batch
        cached = _EVAL_GRID_CACHE.get((key, T))
        if cached is None:
            coords_rep, t_rep = dense_grid_points(T, s0.coords)
            n = coords_rep.shape[0]
            n_pad = round_up(n, chunk)
            coords_p = np.zeros((n_pad, 2), np.float32)
            coords_p[:n] = coords_rep
            t_p = np.zeros((n_pad, 1), np.float32)
            t_p[:n] = t_rep.reshape(n, 1)
            z = s0.z_full.ravel().astype(np.float32)  # shared across group
            cached = (n, n_pad, jnp.asarray(coords_p), jnp.asarray(t_p),
                      jnp.asarray(z))
            if len(_EVAL_GRID_CACHE) >= 4:
                _EVAL_GRID_CACHE.clear()
            _EVAL_GRID_CACHE[(key, T)] = cached
        n, n_pad, coords_d, t_d, z_d = cached
        n_chunks = n_pad // chunk
        labels_b = np.stack([
            setups[li].train_mask.ravel().astype(np.int8) * 1
            + setups[li].valid_mask.ravel().astype(np.int8) * 2
            + setups[li].test_mask.ravel().astype(np.int8) * 3
            for li in lanes])

        idx = np.asarray(lanes)
        take = lambda t: jax.tree_util.tree_map(lambda x: x[idx], t)
        fn = _device_metrics_program(
            spec_model, list(cfg.quantile_levels), cfg.regression_type,
            n_chunks, n, chunk)
        tau_b = np.asarray(
            [float(getattr(setups[li], "cfg", cfg).current_quantile or 0.5)
             for li in lanes], np.float32)
        vals = np.asarray(fn(take(serve_params), take(consts_d),
                             coords_d, t_d, z_d, jnp.asarray(labels_b),
                             jnp.asarray(tau_b)))

        for gi, li in enumerate(lanes):
            lane = {}
            for si, split in enumerate(("train_metrics", "val_metrics",
                                        "test_metrics")):
                row = vals[gi, si]
                m = {"mse": float(row[0]), "mae": float(row[1]),
                     "rmse": float(np.sqrt(row[0]))}
                if cfg.regression_type == "multi-quantile":
                    m["crps"] = float(row[2])
                    m["mean_check_loss"] = float(row[3])
                    m["check_loss"] = float(row[3])
                elif cfg.regression_type == "quantile":
                    m["check_loss"] = float(row[2])
                lane[split] = m
            out[li] = lane
    return out


def experiment_mesh(axis: str = "exp") -> Mesh:
    # DCN-aware device order: on a pod, lanes group contiguously per
    # host/slice (exp is collective-free, so this is layout hygiene only);
    # single host it is exactly Mesh(jax.devices(), (axis,)).
    from st_dadk_tpu.parallel.multihost import experiment_mesh_auto
    return experiment_mesh_auto(axis)


def run_experiment_batch(
    cfg: ExperimentConfig,
    exp_ids: List[int],
    experiments_dir: Path,
    skip_existing: bool = False,
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
) -> List[Dict[str, Any]]:
    """Run all `exp_ids` of one config as a single vmapped program.

    The separate-models-per-tau quantile mode (regression_type='quantile'
    with multiple levels — ref train_st_interp.py:1973-2151) expands into
    exp_ids x quantile_levels LANES of one batch: tau is a runtime lane
    value (consts['tau']), so all taus share one compiled program. Per-tau
    artifacts land in <i>/quantile_<q>/ exactly like the sequential path,
    and the per-experiment CRPS aggregation reuses run_single_experiment's
    reload path (per-tau predictions.npz are materialized for it)."""
    experiments_dir = Path(experiments_dir)
    if is_per_tau(cfg):
        jobs = expand_per_tau_jobs(cfg, exp_ids, experiments_dir)
        run_lane_jobs(jobs, cfg, skip_existing=skip_existing,
                      verbose=verbose, epochs_chunk=epochs_chunk, mesh=mesh)
        return aggregate_per_tau(cfg, exp_ids, experiments_dir,
                                 skip_existing=skip_existing,
                                 verbose=verbose)
    jobs = [(cfg, i, experiments_dir / str(i)) for i in exp_ids]
    return run_lane_jobs(jobs, cfg, skip_existing=skip_existing,
                         verbose=verbose, epochs_chunk=epochs_chunk,
                         mesh=mesh)


def is_per_tau(cfg: ExperimentConfig) -> bool:
    """Separate-models-per-tau quantile mode (ref :1973-2151)."""
    return (cfg.regression_type == "quantile"
            and len(cfg.quantile_levels) > 1)


def expand_per_tau_jobs(cfg: ExperimentConfig, exp_ids: List[int],
                        experiments_dir: Path) -> List:
    """One lane per (experiment, tau); artifacts land in <i>/quantile_<q>/
    like the sequential path (predictions.npz are materialized because the
    aggregation reloads them)."""
    jobs = []
    for i in exp_ids:
        for q in cfg.quantile_levels:
            qcfg = cfg.replace(current_quantile=float(q),
                               save_artifacts=True)
            jobs.append((qcfg, i,
                         Path(experiments_dir) / str(i) / f"quantile_{q}"))
    return jobs


def aggregate_per_tau(cfg: ExperimentConfig, exp_ids: List[int],
                      experiments_dir: Path, skip_existing: bool,
                      verbose: bool = False,
                      sync: bool = True) -> List[Dict[str, Any]]:
    """Per-experiment CRPS aggregation across the per-tau lane artifacts,
    via run_single_experiment's reload path. Primary-process-only on pods
    (lanes were written by their owning processes). A fresh run
    (skip_existing=False) drops each experiment's stale top-level
    results.json first so the reload path cannot short-circuit on it.
    `sync=False` when the caller already barriered + primary-gated (a
    barrier entered by only one process would deadlock a pod)."""
    from st_dadk_tpu.parallel.multihost import is_primary, sync_processes
    from st_dadk_tpu.train.experiment import run_single_experiment

    if sync:
        sync_processes("st_dadk_per_tau_aggregate")
        if not is_primary():
            return []
    out = []
    for i in exp_ids:
        exp_dir = Path(experiments_dir) / str(i)
        if not skip_existing:
            (exp_dir / "results.json").unlink(missing_ok=True)
        out.append(run_single_experiment(cfg, i, exp_dir, verbose=verbose,
                                         skip_existing=True))
    return out


_STACKABLE_KEYS = frozenset({
    "data_file", "obs_method", "obs_ratio", "obs_spatial_pattern",
    "obs_spatial_intensity", "split_method", "train_ratio",
    "normalize_target", "tag", "config_id", "base_seed", "n_experiments",
    "extra", "data_root", "save_plots", "save_artifacts", "n_jobs",
    "num_workers", "device",
    # runtime lane value when lanes mix (consts['tau']); static otherwise
    "current_quantile",
})


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def stacking_key(cfg: ExperimentConfig):
    """Configs whose non-observation fields match compile to the SAME lane
    program and may share one vmapped batch (see run_job_batch).

    With k_spatial_pad set (ragged-k stacking), k_spatial_centers becomes a
    per-lane property — the compiled program is determined by the shared pad
    width, so configs differing only in their real k layout stack.

    cfg.extra IS part of the key: its recognized knobs (init_em_dtype /
    init_gmm_n_init / init_subsample / init_seed_rounds / shuffle /
    pregather / lanes_per_device / ...) change the init or epoch program,
    and the engine reads them from the bucket's FIRST config — a sweep
    whose param_grid varies only an extra knob must therefore split into
    one bucket per value, not silently run every lane with the first
    value. Unknown extra keys split too (correctness over lane packing)."""
    import dataclasses
    d = dataclasses.asdict(cfg)
    skip = set(_STACKABLE_KEYS)
    if cfg.k_spatial_pad is not None:
        skip.add("k_spatial_centers")
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in d.items() if k not in skip)) + (("extra",
                                                     _freeze(cfg.extra)),)


# Wide workloads run as a pipelined STREAM of batches of at most this many
# lanes per device. The value was tuned on another accelerator and is kept
# so behaviour does not change; the width sweep that should set it for the
# GPU is ROADMAP Speed item 3. Override per config with
# cfg.extra['lanes_per_device'].
LANES_PER_DEVICE = 16

# train_dtype='auto' (the default) resolves to the bf16 trunk once a
# compiled batch runs wider than this many lanes per device; at or below it
# the trunk stays f32 (the same program as an explicit 'f32'). The switch
# point was set on another accelerator and is kept so behaviour does not
# change; ROADMAP Speed items 3 and 5 measure it on the GPU. The model-SIZE
# trigger lives in st_interp.AUTO_BF16_HIDDEN_SUM.
AUTO_BF16_LANES = 16


def _padded_lanes_per_device(M: int, n_dev: int,
                             lane_width: Optional[int]) -> int:
    """Lane width per device of the COMPILED batch program (mirrors the
    tail padding in _prepare_job_batch/_execute_job_batch: ragged tails are
    padded up to the stream's common width)."""
    M_pad = M + ((-M) % n_dev)
    if (lane_width is not None and M_pad < lane_width
            and lane_width % n_dev == 0):
        M_pad = lane_width
    return M_pad // n_dev


def _apply_auto_train_dtype(cfg: ExperimentConfig, setups: List,
                            lanes_per_device: int) -> None:
    """Resolve train_dtype='auto' for one batch: flip every lane's spec to
    the bf16 trunk when the compiled program runs wide (see AUTO_BF16_LANES).
    At narrow widths the specs already carry the f32 resolution from
    spec_from_config, so nothing changes and the compiled-program cache
    stays warm. An explicit 'f32'/'bf16' config is never overridden."""
    if cfg.train_dtype != "auto" or lanes_per_device <= AUTO_BF16_LANES:
        return
    import dataclasses
    for s in setups:
        if s.spec.compute_dtype != "bf16":
            s.spec = dataclasses.replace(s.spec, compute_dtype="bf16")


def run_lane_jobs(
    jobs: List,
    cfg: ExperimentConfig,
    skip_existing: bool = False,
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
) -> List[Dict[str, Any]]:
    """Run a lane-job list in batches of LANES_PER_DEVICE lanes per device.

    Wider lists become a pipelined run_job_batches stream whose TAIL batch
    is padded back up to the common width (lane_width) so it reuses the same
    compiled program instead of compiling a fresh one for its ragged
    shape."""
    mesh_l = mesh or experiment_mesh(cfg.mesh_axis)
    width = (int(cfg.extra.get("lanes_per_device", LANES_PER_DEVICE))
             * mesh_l.devices.size)
    if len(jobs) <= width:
        return run_job_batch(jobs, skip_existing=skip_existing,
                             verbose=verbose, epochs_chunk=epochs_chunk,
                             mesh=mesh)
    batches = [jobs[i:i + width] for i in range(0, len(jobs), width)]
    return run_job_batches(batches, skip_existing=skip_existing,
                           verbose=verbose, epochs_chunk=epochs_chunk,
                           mesh=mesh, lane_width=width)


def run_job_batch(
    jobs: List,
    skip_existing: bool = False,
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
    lane_width: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Run heterogeneous (cfg, experiment_id, output_dir) jobs as ONE vmapped
    program. All cfgs must share a `stacking_key` (identical model/loop
    hyperparameters); data files and observation designs may differ per lane
    as long as dataset shapes match. This is config-level stacking: a grid
    search's same-shaped configs multiply the lane axis instead of running
    serially (SURVEY.md section 2.4 row 2)."""
    state = _train_job_batch(jobs, skip_existing=skip_existing,
                             verbose=verbose, epochs_chunk=epochs_chunk,
                             mesh=mesh, lane_width=lane_width)
    return _finalize_job_batch(state) if state else []


def run_job_batches(
    batches: List[List],
    skip_existing: bool = False,
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
    lane_width: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Pipelined stream of job batches. While batch k trains on device:
      - batch k+1's host preparation (seed-exact masks, stacking, LR tables)
        runs on a prepare thread (the device would otherwise idle through
        those ~0.4 s of host work), and
      - earlier batches' finalizes (packed result pull + eval dispatch +
        artifacts) run on a finalize thread, drained NON-blockingly by the
        dispatch loop (bounded at two in flight) so finalize latency never
        gates the next batch's init dispatch.
    The device queue serializes the actual compute.
    Global-numpy-RNG sections are mutually excluded via
    utils.seed.GLOBAL_NP_RNG_LOCK, which preserves the engines' bit-exact
    mask/init streams (the GMM replay itself is lock-free on a private
    RandomState, ops/init_centers.py).

    Multi-process (pod) runs fall back to the serial prepare/train/finalize
    loop: every process must dispatch the SAME SPMD programs in the SAME
    order, and the pipeline's prepare/finalize threads would interleave
    dispatches differently on different hosts."""
    from concurrent.futures import ThreadPoolExecutor

    from st_dadk_tpu.parallel.multihost import process_info

    if process_info()[0] > 1:
        results = []
        for jobs in batches:
            results.extend(run_job_batch(jobs, skip_existing=skip_existing,
                                         verbose=verbose,
                                         epochs_chunk=epochs_chunk, mesh=mesh,
                                         lane_width=lane_width))
        return results

    from collections import deque

    results: List[Dict[str, Any]] = []
    it = iter(batches)
    with ThreadPoolExecutor(max_workers=1) as prep_ex, \
            ThreadPoolExecutor(max_workers=1) as fin_ex:

        def submit_next_prepare():
            jobs = next(it, None)
            if jobs is None:
                return None
            return prep_ex.submit(_prepare_job_batch, jobs,
                                  skip_existing=skip_existing,
                                  lane_width=lane_width)

        prep_fut = submit_next_prepare()
        fin_futs: deque = deque()
        while prep_fut is not None:
            prep = prep_fut.result()
            prep_fut = submit_next_prepare()   # overlaps this batch's training
            state = (_execute_job_batch(prep, verbose=verbose,
                                        epochs_chunk=epochs_chunk, mesh=mesh,
                                        lane_width=lane_width)
                     if prep is not None else [])
            # drain completed finalizes WITHOUT blocking the dispatch loop: a
            # blocking fin.result() here would put batch k-1's finalize tail
            # (pulls + host assembly) on the critical path of batch k+1's
            # init dispatch, idling the device. At most two stay in flight
            # so trained-batch device state cannot pile up when finalize is
            # the slower side.
            blocking = bool(state) and bool(state["cfg"].extra.get(
                "pipeline_blocking_finalize", False))  # measurement baseline
            while fin_futs and (blocking or fin_futs[0].done()
                                or len(fin_futs) >= 2):
                results.extend(fin_futs.popleft().result())
            if state:
                fin_futs.append(fin_ex.submit(_finalize_job_batch, state))
        while fin_futs:
            results.extend(fin_futs.popleft().result())
    return results


def _prepare_job_batch(
    jobs: List,
    skip_existing: bool = False,
    lane_width: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """Pure-host batch preparation: per-lane setups (seed-exact masks),
    stacked lane data, LR tables, loop spec. No jax dispatch happens here, so
    `run_job_batches` can run this for batch k+1 on a host thread while batch
    k trains on the device (the device would otherwise idle ~0.5 s/batch
    through these host phases)."""
    t_start = time.time()

    todo = []
    for cfg_i, exp_id, out_dir in jobs:
        if skip_existing and (Path(out_dir) / "results.json").exists():
            continue
        todo.append((cfg_i, exp_id, Path(out_dir)))
    if not todo:
        return None

    cfg = todo[0][0]
    keys0 = {stacking_key(c) for c, _, _ in todo}
    if len(keys0) != 1:
        raise ValueError("run_job_batch: configs are not stackable "
                         "(differing model/loop hyperparameters)")

    from st_dadk_tpu.parallel.multihost import (process_info,
                                                process_lane_slice)
    from st_dadk_tpu.utils.seed import GLOBAL_NP_RNG_LOCK

    # per-lane cfg normalization BEFORE any process-local split so every
    # process derives identical global lane metadata (taus, seeds)
    norm_todo = []
    for cfg_i, exp_id, out_dir in todo:
        if cfg_i.regression_type == "quantile" \
                and cfg_i.current_quantile is None:
            # sequential-path normalization (experiment.py): an unset
            # tau means the first quantile level, NOT 0.5
            cfg_i = cfg_i.replace(
                current_quantile=float(cfg_i.quantile_levels[0]))
        norm_todo.append((cfg_i, exp_id, out_dir))

    def build_setup(cfg_i, exp_id, out_dir):
        s = ExperimentSetup(cfg_i, exp_id, verbose=False, defer_model=True)
        s.cfg = cfg_i
        s.out_dir = out_dir
        return s

    pc, _ = process_info()
    if pc == 1:
        setups = []
        with GLOBAL_NP_RNG_LOCK:  # mask sampling seeds the global numpy RNG
            for job in norm_todo:
                setups.append(build_setup(*job))
        shapes = {(s.T, s.S) for s in setups}
        if len(shapes) != 1:
            raise ValueError(f"run_job_batch: dataset shapes differ: "
                             f"{shapes}")
        _apply_auto_train_dtype(cfg, setups, _padded_lanes_per_device(
            len(setups), experiment_mesh(cfg.mesh_axis).devices.size,
            lane_width))
        stacked = _stack_lane_host(cfg, setups)
        # NOTE: the data-adaptive init (device programs + any host RNG
        # replay) stays on the MAIN thread (_execute_job_batch), so only one
        # thread dispatches device work while a batch trains; its outputs
        # stay on device (init_spatial_centers_batch device_out), so there
        # are no center/bandwidth pulls to overlap in the first place.
        return dict(cfg=cfg, setups=setups, stacked=stacked,
                    t_start=t_start, t_prep=time.time() - t_start)

    # -- pod: per-host STREAMING setup --------------------------------------
    # Each process synthesizes ONLY the lanes living on its own devices
    # (masks, pointsets, inits, LR tables) — setup memory/time is
    # independent of the global lane count. Padded tail rows owned by a
    # process are filled from a duplicate of one of its own lanes (their
    # content never affects results; they are never finalized).
    mesh = experiment_mesh(cfg.mesh_axis)
    n_dev = mesh.devices.size
    M = len(norm_todo)
    M_pad = M + ((-M) % n_dev)
    if (lane_width is not None and M_pad < lane_width
            and lane_width % n_dev == 0):
        # tail batch of a width-split stream (same contract as the
        # single-process pad below): pad to the stream's common width so the
        # pod reuses the compiled program instead of compiling a ragged-M
        # shape. Lane ownership is computed on the padded count, so this
        # must happen HERE at prepare time.
        M_pad = lane_width
    sl = process_lane_slice(M_pad, mesh, cfg.mesh_axis)
    owned_real = list(range(sl.start, min(sl.stop, M)))
    n_pad_local = (sl.stop - sl.start) - len(owned_real)

    setups = []
    with GLOBAL_NP_RNG_LOCK:
        for i in owned_real:
            setups.append(build_setup(*norm_todo[i]))
        pad_setups = []
        if n_pad_local:
            if setups:
                pad_src = setups[-1]
            else:
                # a process owning ONLY pad rows still needs valid lane
                # content; lane setup is seed-self-contained so any real
                # job's setup serves
                pad_src = build_setup(*norm_todo[-1])
            pad_setups = [pad_src] * n_pad_local
    if setups:
        shapes = {(s.T, s.S) for s in setups}
        if len(shapes) != 1:
            raise ValueError(f"run_job_batch: dataset shapes differ: "
                             f"{shapes}")
    _apply_auto_train_dtype(cfg, setups + pad_setups, M_pad // n_dev)
    return dict(cfg=cfg, setups=setups, pad_setups=pad_setups,
                lane_cfgs=[j[0] for j in norm_todo], mesh=mesh,
                M_global=M, M_pad=M_pad, owned_slice=sl, streaming=True,
                t_start=t_start, t_prep=time.time() - t_start)


_LANE_KEYS_JIT = None


def _lane_keys(setups: List):
    """All lane PRNG keys in ONE device program (bit-identical to per-lane
    jax.random.PRNGKey, tested) instead of 2 tiny dispatches per lane on the
    main dispatch thread every batch."""
    global _LANE_KEYS_JIT
    if _LANE_KEYS_JIT is None:
        _LANE_KEYS_JIT = jax.jit(jax.vmap(jax.random.PRNGKey))
    # int64 -> int32 wrap matches what jnp.asarray did to each python seed
    return _LANE_KEYS_JIT(np.asarray(
        [s.experiment_seed for s in setups], np.int64).astype(np.int32))


def _lane_coords(cfg: ExperimentConfig, setups: List) -> List:
    from st_dadk_tpu.ops.init_centers import DATA_ADAPTIVE_INIT_METHODS
    needs = cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS
    return [s.train_ps.coords if needs else None for s in setups]


def _lane_lr_tables(cfg, datas, B_shared):
    """Per-lane LR tables: warmup pacing depends on the lane's OWN batches
    per epoch (W = warmup_epochs * B_lane), which can differ across lanes
    when observation counts straddle a ceil(n/batch) boundary. Lanes with
    B_lane < B_shared get their surplus steps padded with the last real
    step's LR (those steps are masked in the loop anyway).

    Returns (lr_steps (M, epochs, B_shared, 2), lr_recorded_lanes)."""
    lr_tabs, lr_recorded_lanes = [], []
    lr_cache: Dict[int, Any] = {}
    for data in datas:
        B_lane = int(data.n_batches)
        if B_lane not in lr_cache:
            lm, lb, lrec = build_lr_tables(cfg, B_lane)
            tab = np.stack([lm, lb], -1).reshape(cfg.epochs, B_lane, 2)
            if B_lane < B_shared:
                tab = np.concatenate(
                    [tab, np.repeat(tab[:, -1:], B_shared - B_lane, axis=1)],
                    axis=1)
            lr_cache[B_lane] = (tab, lrec)
        tab, lrec = lr_cache[B_lane]
        lr_tabs.append(tab)
        lr_recorded_lanes.append(lrec)
    return np.stack(lr_tabs), lr_recorded_lanes


def _stack_lane_host(cfg: ExperimentConfig, setups: List) -> Dict[str, Any]:
    """Pure-host lane stacking: per-lane train/val buffers, the stacked
    numpy data tree, and per-lane LR tables. No jax dispatch — callable from
    the prepare thread so the device never idles through it (the main
    thread used to spend ~0.15 s here between the init and fit dispatches
    of every batch)."""
    batch_size = adaptive_batch_size(
        min(s.train_ps.n_real for s in setups), cfg.batch_size)
    B_shared = max(-(-s.train_ps.n_real // batch_size) for s in setups)
    cap_tr = B_shared * batch_size
    max_val = max(max(1, s.valid_ps.n_real) for s in setups)
    val_chunk = min(max(batch_size * 16, 32768), max_val)
    n_val_chunks = max(1, -(-max_val // val_chunk))
    cap_va = n_val_chunks * val_chunk

    datas = []
    for s in setups:
        data, _, _ = prepare_train_data(s.train_ps, s.valid_ps, batch_size,
                                        val_chunk=val_chunk, cap_tr=cap_tr,
                                        cap_va=cap_va)
        datas.append(data)
    data_b = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *datas)

    lr_steps, lr_recorded_lanes = _lane_lr_tables(cfg, datas, B_shared)

    return dict(batch_size=batch_size, B_shared=B_shared,
                val_chunk=val_chunk, n_val_chunks=n_val_chunks,
                datas=datas, data_b=data_b, lr_steps=lr_steps,
                lr_recorded_lanes=lr_recorded_lanes)


def _train_job_batch(
    jobs: List,
    skip_existing: bool = False,
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
    lane_width: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """Setup + batched init + the chunked training loop. Returns the state
    `_finalize_job_batch` needs; result pulls happen there so a caller can
    overlap them with the next batch's training."""
    prep = _prepare_job_batch(jobs, skip_existing=skip_existing,
                              lane_width=lane_width)
    if prep is None:
        return []
    return _execute_job_batch(prep, verbose=verbose,
                              epochs_chunk=epochs_chunk, mesh=mesh,
                              lane_width=lane_width)


def _execute_job_batch(
    prep: Dict[str, Any],
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
    lane_width: Optional[int] = None,
) -> Dict[str, Any]:
    """Device side of one batch: batched data-adaptive init, lane upload,
    and the chunked training loop."""
    if prep.get("streaming"):
        return _execute_job_batch_streaming(prep, verbose=verbose,
                                            epochs_chunk=epochs_chunk,
                                            mesh=mesh)
    cfg, setups = prep["cfg"], prep["setups"]
    t_start = prep["t_start"]

    t_phase = time.time()
    spec_model = setups[0].spec

    # host lane stacking: prebuilt on the prepare thread when this batch
    # came through the pipelined runner, inline otherwise (direct callers)
    stacked = prep.get("stacked") or _stack_lane_host(cfg, setups)
    batch_size = stacked["batch_size"]
    B_shared = stacked["B_shared"]
    val_chunk = stacked["val_chunk"]
    n_val_chunks = stacked["n_val_chunks"]
    datas = stacked["datas"]

    # lanes stacked on host (numpy); uploaded ONCE with the lane sharding at
    # the device_put below (an eager per-leaf asarray here would upload every
    # leaf unsharded and then re-place it). Model init + carry construction
    # is ONE jitted program per lane k-group (see loop.prepare_carry_batch);
    # a ragged-k batch (cfg.k_spatial_pad) has one group per distinct
    # k_spatial_centers, concatenated back into lane order.
    data_b = stacked["data_b"]
    # the init runs HERE on the main thread, not on the prepare thread (see
    # the NOTE in _prepare_job_batch)
    carry_b, consts_b, n_params_lanes = _init_lane_carries(
        cfg, setups, _lane_keys(setups), _lane_coords(cfg, setups))
    t_setup = prep["t_prep"] + (time.time() - t_phase)
    mixed_tau = False
    tau0 = None
    if cfg.regression_type == "quantile":
        # lane cfgs are tau-normalized in _prepare_job_batch
        taus = np.asarray([float(s.cfg.current_quantile) for s in setups],
                          np.float32)
        tau0 = float(taus[0])
        mixed_tau = len(set(taus.tolist())) > 1
        if mixed_tau:
            # per-tau lanes of a stacked quantile batch: tau becomes LANE
            # DATA (consts['tau']) so every tau shares one compiled program
            consts_b = dict(consts_b, tau=jnp.asarray(taus))

    # consts_host pull + per-setup assignment happen in _finalize_job_batch
    # (finalize thread): pulling here blocked the main thread on the init
    # program's completion BETWEEN the init and fit dispatches — a device
    # idle bubble on every batch of the pipelined stream

    import dataclasses
    E = cfg.epochs
    chunk = min(epochs_chunk, E)
    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B_shared,
                                val_chunk, n_val_chunks)
    if mixed_tau:
        spec = dataclasses.replace(spec, current_quantile=None)
    elif tau0 is not None:
        # uniform-tau batch: static tau from the (normalized) lane cfgs —
        # the job-level cfg may still carry current_quantile=None
        spec = dataclasses.replace(spec, current_quantile=tau0)
    if any(int(d.n_batches) != B_shared for d in datas):
        # heterogeneous lanes: epoch shuffles must stable-partition so every
        # lane sees all of its own data (costs an argsort per epoch)
        spec = dataclasses.replace(spec, uniform_lanes=False)
    if spec.record_centers and chunk > 100:
        # round the chunk DOWN to a multiple of 100 so the per-100-epoch
        # trajectory sampling below stays available for any epoch budget
        # (e.g. epochs=250 -> chunks 200+50, not one 250 that would force
        # per-epoch center history)
        chunk -= chunk % 100
    if spec.record_centers and chunk % 100 == 0:
        # slice the center trajectory to the reference's per-100-epoch
        # sampling ON DEVICE: shrinks each chunk's history transfer by ~100x
        spec = dataclasses.replace(spec, centers_every=100)
    lr_steps = stacked["lr_steps"]        # (M, epochs, B_shared, 2)
    lr_recorded_lanes = stacked["lr_recorded_lanes"]

    # -- shard the experiment axis over the mesh ------------------------------
    mesh = mesh or experiment_mesh(cfg.mesh_axis)
    n_dev = mesh.devices.size
    M = len(setups)
    pad_lanes = (-M) % n_dev
    if (lane_width is not None and M + pad_lanes < lane_width
            and lane_width % n_dev == 0):
        # tail batch of a width-split stream: pad up to the stream's common
        # width so this batch reuses the already-compiled program instead
        # of compiling a fresh ragged-M shape
        pad_lanes = lane_width - M
    if pad_lanes:
        # data_b is still HOST numpy here — pad it with numpy so the only
        # device transfer is the sharded placement below (a jnp.concatenate
        # would upload the whole batch unsharded first, the exact double
        # upload the single-placement invariant above exists to avoid);
        # carry/consts are already device-resident, so jnp padding there is
        # a cheap on-device op, not an upload
        dup_np = lambda t: jax.tree_util.tree_map(
            lambda x: np.concatenate(
                [x, np.repeat(x[-1:], pad_lanes, axis=0)]), t)
        dup_dev = lambda t: jax.tree_util.tree_map(
            lambda x: jnp.concatenate(
                [x, jnp.repeat(x[-1:], pad_lanes, axis=0)]), t)
        data_b, carry_b, consts_b = (dup_np(data_b), dup_dev(carry_b),
                                     dup_dev(consts_b))
        lr_steps = np.concatenate(
            [lr_steps, np.repeat(lr_steps[-1:], pad_lanes, axis=0)])

    # single-process: plain device_put; multi-process: per-host lane shards
    # assembled into global arrays (parallel/multihost.py)
    from st_dadk_tpu.parallel.multihost import shard_lanes_multihost
    shard = lambda t: shard_lanes_multihost(t, mesh, cfg.mesh_axis)
    if jax.process_count() == 1 and cfg.extra.get("packed_upload", False):
        # opt-in: one packed host->device transfer instead of per-leaf
        # uploads (unmeasured on the GPU; ROADMAP Design item 2)
        data_b = _upload_lanes_packed(data_b, mesh, cfg.mesh_axis)
    else:
        data_b = shard(data_b)
    carry_b, consts_b = shard(carry_b), shard(consts_b)

    fit_chunk = jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)

    # -- chunked epoch loop (early exit when every lane has stopped) ----------
    # Default chunk = 500 (one dispatch for the reference's full epoch budget):
    # the epoch program is an early-exit while_loop, so a single big chunk
    # stops at the batch's max stop epoch anyway, and dropping the per-chunk
    # dispatch + stopped-sync turnarounds measured ~7% faster than the
    # round-1 100-epoch grid with bit-identical results. Small-epoch configs
    # still compile small programs (chunk = min(epochs_chunk, E)).
    #
    # TAIL COMPACTION: the while_loop freezes early-stopped lanes but still
    # pays their lane width every epoch — with stop epochs spread over
    # ~[72, 180], roughly a third of the full-width scan is frozen lanes.
    # After `compaction_epoch` full-width epochs, still-active lanes are
    # gathered into a power-of-two-width program (padded with already-
    # stopped lanes, which stay frozen) and run to completion there; the
    # compacted carry is scattered back for finalize. Lanes are independent
    # and frozen carries never change, so results are unchanged (tested).
    # Single-process only (a pod gather would reshard across hosts).
    ce = spec.centers_every
    M_pad = M + pad_lanes
    # full-width chunk length while awaiting compaction: the epoch program
    # requires chunk % centers_every == 0 when trajectories are recorded
    L_precompact = min(chunk, max(cfg.compaction_epoch, 1))
    if ce > 1:
        L_precompact -= L_precompact % ce
    compact_enabled = (cfg.tail_compaction and jax.process_count() == 1
                       and 0 < cfg.compaction_epoch < E
                       and L_precompact > 0
                       and M_pad >= 2 * max(n_dev, 1))

    def chunk_inputs(e0, c, L, lr_host):
        """ids/lr/active for a dispatch of static length L covering c real
        epochs from e0 (padding repeats the last epoch, masked inactive)."""
        ids = np.arange(e0, e0 + c, dtype=np.int32)
        lr_c = np.ascontiguousarray(lr_host[:, e0:e0 + c])
        active = np.ones((L,), bool)
        if c != L:
            ids = np.concatenate([ids, np.full((L - c,), E - 1, np.int32)])
            lr_c = np.concatenate(
                [lr_c, np.repeat(lr_c[:, -1:], L - c, 1)], 1)
            active[c:] = False
        return jnp.asarray(ids), lr_c, jnp.asarray(active)

    hists = []
    epochs_done = 0
    lane_idx = None            # None = full width (identity lane mapping)
    carry_cur, consts_cur, data_cur = carry_b, consts_b, data_b
    carry_full = carry_b       # latest FULL-width carry (fit_chunk donates
                               # its carry input, so only outputs stay live)
    lr_cur = lr_steps
    while epochs_done < E:
        if compact_enabled and lane_idx is None \
                and epochs_done >= cfg.compaction_epoch:
            stopped = np.asarray(carry_cur["stopped"])
            act = np.flatnonzero(~stopped)
            # width = next multiple of q, where q is itself a multiple of
            # n_dev (even lane shards) of size ~M_pad/4: at most 3 distinct
            # tail-program widths per batch shape (compile-once each,
            # persistent-cached) while still narrowing when e.g. 10 of 16
            # lanes remain active
            q = -(-max(M_pad // 4, 1) // max(n_dev, 1)) * max(n_dev, 1)
            q = max(q, 4) if n_dev <= 4 else q
            W = -(-max(len(act), 1) // q) * q
            if len(act) > 0 and W < M_pad:
                # pad the active set with (distinct) stopped lanes: frozen,
                # so they cost compute but cannot change any result
                idx_np = np.concatenate(
                    [act, np.flatnonzero(stopped)[: W - len(act)]])
                idx_dev = jnp.asarray(idx_np, jnp.int32)
                carry_cur = _lane_gather(carry_full, idx_dev)
                consts_cur = _lane_gather(consts_b, idx_dev)
                data_cur = _lane_gather(data_b, idx_dev)
                lr_cur = lr_steps[idx_np]
                lane_idx = idx_np
                if verbose:
                    print(f"[batch] tail compaction {M_pad}->{W} lanes "
                          f"at epoch {epochs_done} ({len(act)} active)")
            # not narrowable yet: stay full-width at the compaction-interval
            # chunk length and re-attempt after the next chunk
        if compact_enabled and lane_idx is None:
            # full-width chunks end at compaction-interval boundaries so
            # their program length is stable across batches and compaction
            # can re-attempt as more lanes stop
            L = L_precompact
            c = min(L, E - epochs_done)
        else:
            L = chunk
            c = min(chunk, E - epochs_done)
        ids, lr_c, active = chunk_inputs(epochs_done, c, L, lr_cur)
        # lane-sharded upload: plain device_put single-process, per-process
        # shard assembly on a pod (device_put cannot target devices this
        # process does not own)
        lr_c = shard(lr_c) if lane_idx is None else jax.device_put(
            jnp.asarray(lr_c), NamedSharding(mesh, P(cfg.mesh_axis)))
        carry_cur, hist = fit_chunk(carry_cur, consts_cur, data_cur, ids,
                                    lr_c, active)
        if lane_idx is None:
            carry_full = carry_cur
        # scalars sliced to the real epochs; sparse centers rows sliced to
        # those whose global epoch lands within the real span. Kept as DEVICE
        # arrays here; _finalize_job_batch pulls them (possibly overlapped
        # with the next batch's training).
        h = {k: (v[:, :c] if not (k == "centers" and ce > 1)
                 else v[:, : max(c // ce, 0)])
             for k, v in hist.items()}
        h["_lane_idx"] = lane_idx
        hists.append(h)
        epochs_done += c
        # skip the stopped-flag sync on the FINAL chunk: the pull blocks the
        # host until the whole fit program completes, and with the default
        # single 500-epoch chunk that would serialize every next-batch
        # main-thread dispatch (init upload + GMM program) behind this
        # batch's fit — a device bubble on every batch of the stream.
        # When the loop exits on the epoch budget anyway, nothing consumes
        # the flag; finalize pulls ride their own thread. Mid-loop chunks
        # still sync (the early-exit contract). extra['final_stop_sync']
        # restores the old blocking behavior (measurement baseline).
        if (epochs_done < E or cfg.extra.get("final_stop_sync", False)) \
                and _all_lanes_stopped(carry_cur["stopped"], mesh):
            break

    if lane_idx is not None:
        # frozen full-width carry + compacted tail rows -> serving carry
        carry_b = _lane_scatter(carry_full, carry_cur,
                                jnp.asarray(lane_idx, jnp.int32))
    else:
        carry_b = carry_full

    wall = time.time() - t_start
    t_train = prep["t_prep"] + (time.time() - t_phase)
    if verbose:
        print(f"[batch] {M} experiments x {epochs_done} epochs in "
              f"{wall:.1f}s on {n_dev} device(s) "
              f"(setup {t_setup:.1f}s, train {t_train - t_setup:.1f}s)")

    return dict(cfg=cfg, setups=setups, spec=spec, spec_model=spec_model,
                carry_b=carry_b, consts_b=consts_b, consts_host=None,
                n_params_lanes=n_params_lanes,
                hists=hists, ce=ce, epochs_done=epochs_done,
                lr_recorded_lanes=lr_recorded_lanes, M=M, M_pad=M + pad_lanes,
                mesh=mesh, wall=wall,
                t_setup=t_setup, t_train=t_train, verbose=verbose)


def _execute_job_batch_streaming(
    prep: Dict[str, Any],
    verbose: bool = False,
    epochs_chunk: int = 500,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Pod (multi-process) batch execution with per-host STREAMING setup.

    Every process arrives here with ONLY its own lanes synthesized
    (_prepare_job_batch): owned real setups + duplicated pad-row setups.
    Global batch scalars (shared batch size / batches-per-epoch / validation
    chunking) come from one tiny allgather of per-lane counts; all device
    inputs are assembled as global lane-sharded jax.Arrays from each
    process's local rows (jax.make_array_from_process_local_data), so
    per-process setup memory/time is independent of the global lane count.
    Results are identical to the all-host-synthesis path: lanes are
    seed-self-contained, and the compiled SPMD programs are unchanged."""
    import dataclasses

    from jax.experimental import multihost_utils

    cfg = prep["cfg"]
    setups = prep["setups"]                     # owned REAL lanes
    local_setups = setups + prep["pad_setups"]  # rows [sl.start, sl.stop)
    lane_cfgs = prep["lane_cfgs"]
    M, M_pad, sl = prep["M_global"], prep["M_pad"], prep["owned_slice"]
    t_start = prep["t_start"]
    mesh = mesh or prep["mesh"]
    if mesh.devices.size != prep["mesh"].devices.size:
        raise ValueError("streaming setup computed lane ownership for a "
                         f"{prep['mesh'].devices.size}-device mesh; caller "
                         f"passed {mesh.devices.size} devices")
    axis = cfg.mesh_axis
    n_dev = mesh.devices.size
    L = len(local_setups)

    t_phase = time.time()
    keys_local = _lane_keys(local_setups)
    coords_list = _lane_coords(cfg, local_setups)
    spec_model = local_setups[0].spec

    # -- global batch scalars from an allgather of per-lane counts ----------
    # (T, S) rides along so the dataset-shape guard spans PROCESSES: each
    # process's local check can't see that another host's lanes load a
    # different-shape dataset
    counts_local = np.array([[s.train_ps.n_real, max(1, s.valid_ps.n_real),
                              s.T, s.S]
                             for s in local_setups], np.int64)
    gathered = np.asarray(multihost_utils.process_allgather(counts_local))
    rows_global = gathered.reshape(M_pad, 4)[:M]     # pad rows excluded
    shapes_global = {tuple(r) for r in rows_global[:, 2:4].tolist()}
    if len(shapes_global) != 1:
        raise ValueError(f"run_job_batch: dataset shapes differ across "
                         f"processes: {shapes_global}")
    counts_global = rows_global[:, :2]
    batch_size = adaptive_batch_size(int(counts_global[:, 0].min()),
                                     cfg.batch_size)
    lane_batches = -(-counts_global[:, 0] // batch_size)
    B_shared = int(lane_batches.max())
    cap_tr = B_shared * batch_size
    max_val = int(counts_global[:, 1].max())
    val_chunk = min(max(batch_size * 16, 32768), max_val)
    n_val_chunks = max(1, -(-max_val // val_chunk))
    cap_va = n_val_chunks * val_chunk

    datas = [prepare_train_data(s.train_ps, s.valid_ps, batch_size,
                                val_chunk=val_chunk, cap_tr=cap_tr,
                                cap_va=cap_va)[0] for s in local_setups]
    data_local = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *datas)
    carry_local, consts_local, n_params_lanes = _init_lane_carries(
        cfg, local_setups, keys_local, coords_list)

    mixed_tau = False
    tau0 = None
    if cfg.regression_type == "quantile":
        taus_global = np.asarray([float(c.current_quantile)
                                  for c in lane_cfgs], np.float32)
        tau0 = float(taus_global[0])
        mixed_tau = len(set(taus_global.tolist())) > 1
        if mixed_tau:
            taus_local = np.asarray(
                [float(s.cfg.current_quantile) for s in local_setups],
                np.float32)
            consts_local = dict(consts_local, tau=jnp.asarray(taus_local))

    consts_host = jax.tree_util.tree_map(np.asarray, consts_local)
    for i, s in enumerate(setups):               # owned REAL lanes only
        s.consts = jax.tree_util.tree_map(lambda x, i=i: x[i], consts_host)
        s.n_params = n_params_lanes[i]

    E = cfg.epochs
    chunk = min(epochs_chunk, E)
    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B_shared,
                                val_chunk, n_val_chunks)
    if mixed_tau:
        spec = dataclasses.replace(spec, current_quantile=None)
    elif tau0 is not None:
        spec = dataclasses.replace(spec, current_quantile=tau0)
    if bool((lane_batches != B_shared).any()):
        spec = dataclasses.replace(spec, uniform_lanes=False)
    if spec.record_centers and chunk > 100:
        chunk -= chunk % 100
    if spec.record_centers and chunk % 100 == 0:
        spec = dataclasses.replace(spec, centers_every=100)
    ce = spec.centers_every

    lr_local, lr_recorded_lanes = _lane_lr_tables(cfg, datas, B_shared)

    # -- assemble global lane-sharded arrays from the local rows ------------
    lane_sh = NamedSharding(mesh, P(axis))

    def place_local(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            lane_sh, x, (M_pad,) + tuple(x.shape[1:]))

    assemble = lambda t: jax.tree_util.tree_map(place_local, t)
    data_b = assemble(data_local)
    carry_b = assemble(jax.tree_util.tree_map(np.asarray, carry_local))
    consts_b = assemble(consts_host)
    t_setup = prep["t_prep"] + (time.time() - t_phase)

    fit_chunk = jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)

    # -- chunked epoch loop (no tail compaction on pods) --------------------
    hists = []
    epochs_done = 0
    while epochs_done < E:
        c = min(chunk, E - epochs_done)
        ids = np.arange(epochs_done, epochs_done + c, dtype=np.int32)
        lr_c = np.ascontiguousarray(lr_local[:, epochs_done:epochs_done + c])
        active = np.ones((chunk,), bool)
        if c != chunk:
            ids = np.concatenate([ids, np.full((chunk - c,), E - 1,
                                               np.int32)])
            lr_c = np.concatenate(
                [lr_c, np.repeat(lr_c[:, -1:], chunk - c, 1)], 1)
            active[c:] = False
        carry_b, hist = fit_chunk(carry_b, consts_b, data_b,
                                  jnp.asarray(ids), place_local(lr_c),
                                  jnp.asarray(active))
        h = {k: (v[:, :c] if not (k == "centers" and ce > 1)
                 else v[:, : max(c // ce, 0)])
             for k, v in hist.items()}
        h["_lane_idx"] = None
        hists.append(h)
        epochs_done += c
        # final-chunk sync skipped for the same reason as the vmap engine's
        # loop above: the loop exits on the epoch budget, nothing reads the
        # flag, and on a pod every process skips at the same loop point
        if epochs_done < E and _all_lanes_stopped(carry_b["stopped"], mesh):
            break

    wall = time.time() - t_start
    t_train = prep["t_prep"] + (time.time() - t_phase)
    if verbose:
        print(f"[batch p{jax.process_index()}] {len(setups)} owned of {M} "
              f"experiments x {epochs_done} epochs in {wall:.1f}s on "
              f"{n_dev} device(s)")

    n_real = len(setups)
    return dict(cfg=cfg, setups=setups, spec=spec, spec_model=spec_model,
                carry_b=carry_b, consts_b=consts_b,
                consts_host=jax.tree_util.tree_map(
                    lambda x: x[:n_real], consts_host),
                hists=hists, ce=ce, epochs_done=epochs_done,
                lr_recorded_lanes=lr_recorded_lanes[:n_real],
                M=M, M_pad=M_pad,
                mesh=mesh, wall=wall, local_only=True,
                t_setup=t_setup, t_train=t_train, verbose=verbose)


_PARAM_COUNT_CACHE: Dict[Any, int] = {}
_CONCAT_JIT_CACHE: Dict[Any, Any] = {}


def _count_params_for(spec_real) -> int:
    from st_dadk_tpu.models.st_interp import init_model

    n = _PARAM_COUNT_CACHE.get(spec_real)
    if n is None:
        params = jax.eval_shape(
            lambda k: init_model(k, spec_real),
            jax.ShapeDtypeStruct((2,), jnp.uint32))[0]
        n = int(sum(np.prod(l.shape)
                    for l in jax.tree_util.tree_leaves(params)))
        _PARAM_COUNT_CACHE[spec_real] = n
    return n


def _concat_lane_trees(trees: List[Any], inv: np.ndarray):
    """Concatenate per-group lane trees and reorder rows into lane order.
    One cached jitted program per (structure, shapes, permutation)."""
    treedef = jax.tree_util.tree_structure(trees[0])
    sig = (treedef,
           tuple(tuple(l.shape) for t in trees
                 for l in jax.tree_util.tree_leaves(t)),
           inv.tobytes())
    fn = _CONCAT_JIT_CACHE.get(sig)
    if fn is None:
        inv_c = jnp.asarray(inv, jnp.int32)
        fn = jax.jit(lambda *ts: jax.tree_util.tree_map(
            lambda *xs: jnp.take(jnp.concatenate(xs, axis=0), inv_c,
                                 axis=0), *ts))
        _CONCAT_JIT_CACHE[sig] = fn
    return fn(*trees)


def _init_lane_carries(cfg: ExperimentConfig, setups: List, keys,
                       coords_list: List):
    """Batched data-adaptive init + carry construction for all lanes.

    Uniform batches (every lane shares cfg.k_spatial_centers and
    k_spatial_pad is unset) run the single vmapped program of round 2.
    Ragged-k batches (cfg.k_spatial_pad, SURVEY §7.1 step 6) group lanes by
    their REAL k layout: each group draws params at real shapes (identical
    values to the sequential engine) and zero-pads to the shared width
    (pad_lane_model); groups concatenate back into lane order. Returns
    (carry_b, consts_b, per-lane param counts)."""
    import dataclasses

    from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch

    M = len(setups)
    k_pad = cfg.k_spatial_pad

    groups: Dict[tuple, List[int]] = {}
    for i, s in enumerate(setups):
        groups.setdefault(tuple(getattr(s, "cfg", cfg).k_spatial_centers),
                          []).append(i)

    parts = []
    n_params_lanes = [0] * M
    for klist, idx in groups.items():
        idx_np = np.asarray(idx)
        centers_g, bw_g = init_spatial_centers_batch(
            cfg.spatial_init_method, list(klist),
            [coords_list[i] for i in idx], keys[idx_np],
            rng_states=[setups[i].np_rng_state for i in idx],
            device_out=True,
            em_dtype=cfg.extra.get("init_em_dtype"),
            gmm_n_init=cfg.extra.get("init_gmm_n_init"),
            subsample=cfg.extra.get("init_subsample"),
            seed_rounds=cfg.extra.get("init_seed_rounds"),
            gmm_fused=bool(cfg.extra.get("init_gmm_fused", False)))
        spec_real = dataclasses.replace(
            setups[idx[0]].spec, k_spatial_centers=tuple(klist))
        carry_g, consts_g = prepare_carry_batch(
            spec_real, len(idx),
            k_pad=None if k_pad is None else int(k_pad))(
                keys[idx_np], centers_g, bw_g)
        n_real = _count_params_for(spec_real)
        for i in idx:
            n_params_lanes[i] = n_real
        parts.append((idx_np, carry_g, consts_g))

    if len(parts) == 1:
        return parts[0][1], parts[0][2], n_params_lanes
    order = np.concatenate([p[0] for p in parts])
    inv = np.argsort(order)
    carry_b = _concat_lane_trees([p[1] for p in parts], inv)
    consts_b = _concat_lane_trees([p[2] for p in parts], inv)
    return carry_b, consts_b, n_params_lanes


@jax.jit
def _lane_gather(tree, idx):
    """Rows `idx` of every lane-major leaf (tail-compaction gather)."""
    return jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0), tree)


@jax.jit
def _lane_scatter(full, part, idx):
    """Write compacted rows back into the full-width tree (idx distinct)."""
    return jax.tree_util.tree_map(lambda f, p: f.at[idx].set(p), full, part)


_ALL_STOPPED_JIT: Dict[Any, Any] = {}


def _all_lanes_stopped(stopped, mesh) -> bool:
    """Host-readable all(stopped) for a (possibly) lane-sharded flag vector.

    Single-process arrays are fully addressable — one plain pull. On a pod
    the vector spans non-addressable devices, so the reduction runs as a
    tiny SPMD program with a REPLICATED output (readable on every process);
    all processes dispatch it at the same loop point."""
    if getattr(stopped, "is_fully_addressable", True):
        return bool(np.asarray(stopped).all())
    key = mesh
    fn = _ALL_STOPPED_JIT.get(key)
    if fn is None:
        fn = jax.jit(jnp.all, out_shardings=NamedSharding(mesh, P()))
        _ALL_STOPPED_JIT[key] = fn
    return bool(np.asarray(fn(stopped)))


def _owned_lane_slice(state: Dict[str, Any]) -> slice:
    """Real-lane block this process finalizes. Single-process: all lanes.

    Multi-process (pod): each host pulls, evaluates, and writes artifacts
    ONLY for the lanes living on its devices (`process_lane_slice` over the
    padded lane axis, intersected with the real lanes) — per-lane artifact IO
    never crosses processes, and the non-owned lane rows (which are not
    addressable locally) are never fetched."""
    from st_dadk_tpu.parallel.multihost import process_info, process_lane_slice

    M = state["M"]
    pc, _ = process_info()
    mesh = state.get("mesh")
    if pc == 1 or mesh is None:
        return slice(0, M)
    sl = process_lane_slice(state["M_pad"], mesh, state["cfg"].mesh_axis)
    return slice(min(sl.start, M), min(sl.stop, M))


_PACK_UPLOAD_JIT: Dict[Any, Any] = {}


def _upload_lanes_packed(tree: Any, mesh: Mesh, axis: str) -> Any:
    """Upload a host lane-major tree as ONE flat f32 transfer.

    Mirror of _pull_lanes_packed for the host->device direction: the
    stacked training data is ~10 leaves, each a separate transfer
    otherwise. Leaves are concatenated
    host-side into one (M, total) f32 buffer, placed once with the lane
    sharding, and sliced back into the original leaves by a cached device
    program (slicing along axis 1 never crosses the lane sharding).
    Non-f32 leaves (the int32 per-lane batch counts) are exactly
    representable and cast back on device."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    M = leaves[0].shape[0]
    flat = np.concatenate(
        [np.asarray(l).reshape(M, -1).astype(np.float32) for l in leaves],
        axis=1)
    flat_d = jax.device_put(flat, NamedSharding(mesh, P(axis)))

    key = (tuple((tuple(l.shape), str(l.dtype)) for l in leaves), axis)
    fn = _PACK_UPLOAD_JIT.get(key)
    if fn is None:
        shapes = [(tuple(l.shape), str(l.dtype)) for l in leaves]

        def program(buf):
            outs, off = [], 0
            for shp, dt in shapes:
                n = int(np.prod(shp[1:], dtype=np.int64)) if len(shp) > 1 \
                    else 1
                outs.append(buf[:, off:off + n].reshape(shp).astype(dt))
                off += n
            return outs
        fn = jax.jit(program)
        _PACK_UPLOAD_JIT[key] = fn
    return jax.tree_util.tree_unflatten(treedef, fn(flat_d))


_PACK_PULL_JIT: Dict[Any, Any] = {}


def _pull_lanes_packed(arrs: List[Any], sl: Optional[slice] = None
                       ) -> List[np.ndarray]:
    """Fetch many lane-major device arrays as ONE flat f32 transfer.

    Every device fetch pays a fixed latency and transfers serialize with
    program execution on the device queue, so finalize's per-array fetches
    were direct steady-state wall on the accelerator this engine was first
    tuned on. One concat program + one fetch replaces them (whether that
    matters on a local GPU is ROADMAP Design item 2). Inputs are cast to f32 on
    device and back on the host — every packed leaf is f32 already or an
    exactly-representable bool/epoch-count (same contract as
    pull_serving_state's scalar block)."""
    shapes = tuple((tuple(a.shape), str(a.dtype)) for a in arrs)
    fn = _PACK_PULL_JIT.get(shapes)
    if fn is None:
        def program(*xs):
            M = xs[0].shape[0]
            return jnp.concatenate(
                [x.reshape(M, -1).astype(jnp.float32) for x in xs], axis=1)
        fn = jax.jit(program)
        _PACK_PULL_JIT[shapes] = fn
    flat = np.asarray(fn(*arrs))
    if sl is not None:
        flat = flat[sl]
    outs, off = [], 0
    for a in arrs:
        n = int(np.prod(a.shape[1:], dtype=np.int64)) if a.ndim > 1 else 1
        out = flat[:, off:off + n].reshape(
            (flat.shape[0],) + tuple(a.shape[1:]))
        if str(a.dtype) != "float32":
            out = out.astype(np.dtype(str(a.dtype)))
        outs.append(out)
        off += n
    return outs


def _finalize_job_batch(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Pull results + batched eval + per-lane artifacts for a trained batch.

    Returns results for THIS process's lanes only (all lanes single-process);
    cross-lane summaries re-scan results.json from the shared filesystem on
    the primary process (train/runner.py)."""
    from st_dadk_tpu.parallel.multihost import fetch_lane_rows, process_info
    from st_dadk_tpu.train.loop import (pull_serving_state, pull_tree,
                                        select_serving_device)

    cfg = state["cfg"]
    spec, spec_model = state["spec"], state["spec_model"]
    carry_b, consts_b = state["carry_b"], state["consts_b"]
    M, epochs_done = state["M"], state["epochs_done"]
    t_setup, t_train, wall = state["t_setup"], state["t_train"], state["wall"]
    t_phase = time.time()

    sl = _owned_lane_slice(state)
    if state.get("local_only"):
        # streaming pod path: setups/LR/consts were built for the owned
        # lanes only (already restricted); `sl` still addresses the global
        # lane rows for device-array fetches below
        setups = state["setups"]
        lr_recorded = state["lr_recorded_lanes"]
    else:
        setups = state["setups"][sl]
        lr_recorded = state["lr_recorded_lanes"][sl]

    def _hist_block(h, k):
        """Owned-lane rows of one chunk's history; tail-compacted chunks
        (width W with a _lane_idx mapping) scatter into zeros — rows of
        lanes that stopped before the chunk are never read (assemble_result
        slices each lane's history to its own stop epoch)."""
        idx = h.get("_lane_idx")
        if idx is None:
            return fetch_lane_rows(h[k], sl)
        data = np.asarray(h[k])
        buf = np.zeros((sl.stop - sl.start,) + data.shape[1:], data.dtype)
        m = (idx >= sl.start) & (idx < sl.stop)
        buf[idx[m] - sl.start] = data[m]
        return buf

    hist_keys = [k for k in state["hists"][0] if k != "_lane_idx"]
    hists = state["hists"]
    deferred_consts = state.get("consts_host") is None
    packable = (process_info()[0] == 1
                and bool(cfg.extra.get("packed_finalize_pull", True))
                and all(h.get("_lane_idx") is None for h in hists))
    if packable:
        # ONE fetch for histories + serving scalars + (deferred) consts —
        # see _pull_lanes_packed. Compacted chunks (_lane_idx) and pods
        # keep the per-array path below. All rows are fetched and sliced
        # per consumer on the host: histories/scalars take the owned-lane
        # block, consts keep every lane (the deferred-consts loop assigns
        # ALL setups, same as the unpacked path).
        _, scal_d = select_serving_device(carry_b)
        arrs = [h[k] for h in hists for k in hist_keys]
        arrs.append(jnp.swapaxes(scal_d, 0, 1))
        consts_leaves, consts_def = jax.tree_util.tree_flatten(consts_b)
        if deferred_consts:
            arrs.extend(consts_leaves)
        pulled = iter(_pull_lanes_packed(arrs))
        history_b = {}
        blocks = [[(k, next(pulled)[sl]) for k in hist_keys] for _ in hists]
        for k in hist_keys:
            history_b[k] = np.concatenate(
                [dict(b)[k] for b in blocks], axis=1)
        scal = next(pulled)[sl]
        scal_host = {"best_val": scal[:, 0],
                     "has_best": scal[:, 1].astype(bool),
                     "stopped": scal[:, 2].astype(bool),
                     "stop_epoch": scal[:, 3].astype(np.int32)}
        if deferred_consts:
            state["consts_host"] = jax.tree_util.tree_unflatten(
                consts_def, [next(pulled) for _ in consts_leaves])
    else:
        history_b = {k: np.concatenate([_hist_block(h, k)
                                        for h in hists], axis=1)
                     for k in hist_keys}
    needs_field = any(
        getattr(s, "cfg", cfg).save_artifacts
        or getattr(s, "cfg", cfg).save_plots
        or getattr(s, "cfg", cfg).regression_type == "quantile"
        for s in setups)
    # serving params feed artifact writes, plots, the host eval path, ragged
    # stripping, and NaN postmortems; when none of those apply the ~11 MB
    # per-batch param transfer is pure overhead — pull only the scalar
    # block. Post-stop history rows are NaN by
    # design, so the poison check looks only at each lane's executed epochs.
    if not packable:
        _, scal_host = pull_serving_state(carry_b, lanes=sl,
                                          with_params=False)

    def _any_poisoned() -> bool:
        tl = history_b["train_loss"]
        for li in range(tl.shape[0]):
            n_run = (int(scal_host["stop_epoch"][li])
                     if scal_host["stopped"][li] else epochs_done)
            if np.isnan(tl[li, :n_run]).any():
                return True
        return False

    pull_params = (needs_field or process_info()[0] > 1
                   or cfg.k_spatial_pad is not None or _any_poisoned())
    serve_host = (pull_tree(select_serving_device(carry_b)[0], sl)
                  if pull_params else None)
    if deferred_consts:
        # deferred from _execute_job_batch: the pull now rides the finalize
        # thread (overlapped with the next batch's training) instead of
        # blocking the main thread between the init and fit dispatches.
        # (The packed path above already fetched it in the single transfer.)
        if state.get("consts_host") is None:
            state["consts_host"] = jax.tree_util.tree_map(
                np.asarray, consts_b)
        for i, s in enumerate(state["setups"]):
            s.consts = jax.tree_util.tree_map(
                lambda x, i=i: x[i], state["consts_host"])
            s.n_params = state["n_params_lanes"][i]
    consts_host = (state["consts_host"] if state.get("local_only")
                   else jax.tree_util.tree_map(lambda x: x[sl],
                                               state["consts_host"]))

    # -- batched evaluation: ONE vmapped dense-grid predict for all lanes ----
    # (lanes share the dataset; per-split metrics + predictions.npz payloads
    # all derive from the (M, T*S, Q) field — eval is deterministic, so the
    # values equal per-lane chunked prediction exactly)
    precomputed_lanes = None
    try:
        if needs_field or process_info()[0] > 1:
            # host path: already restricted to the owned lane block (the
            # all-device metrics program would need a global dispatch from
            # every process)
            precomputed_lanes = _batched_eval(cfg, spec_model, serve_host,
                                              consts_host, setups,
                                              len(setups))
        else:
            serve_d, _ = select_serving_device(carry_b)
            precomputed_lanes = _batched_eval_device(
                cfg, spec_model, (serve_d, consts_b), setups, len(setups))
    except Exception as e:
        print(f"[WARNING] batched eval failed, falling back per-lane: {e}")
        if serve_host is None:
            # the params pull was skipped because the device eval was going
            # to provide all metrics; the per-lane fallback DOES consume
            # params, so pull them now (carry_b is still alive)
            serve_host = pull_tree(select_serving_device(carry_b)[0], sl)

    # -- per-lane finalize ------------------------------------------------------
    results = []
    per_lane_time = wall / max(M, 1)
    for li, s in enumerate(setups):
        # serve_host is None only when nothing downstream consumes params
        # (no artifacts/plots, device-eval metrics, no NaN lanes)
        serve_lane = {} if serve_host is None else _lane(serve_host, li)
        lane_carry = {
            "best_ema": serve_lane, "ema": serve_lane,
            "has_best": scal_host["has_best"][li],
            "best_val": scal_host["best_val"][li],
            "stopped": scal_host["stopped"][li],
            "stop_epoch": scal_host["stop_epoch"][li],
        }
        lane_hist = {k: v[li] for k, v in history_b.items()}
        fit_res: FitResult = assemble_result(spec, lane_carry, lane_hist,
                                             lr_recorded[li],
                                             epochs_done)
        out_dir = s.out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        r = finalize_experiment(
            s.cfg, s, fit_res, out_dir, per_lane_time, verbose=False,
            stage_timings={"setup_seconds": t_setup / M,
                           "train_seconds": (t_train - t_setup) / M},
            precomputed=precomputed_lanes[li] if precomputed_lanes else None,
            steps_per_epoch=spec.n_batches)
        r.pop("_split_predictions", None)
        results.append(r)
    if state["verbose"]:
        print(f"[batch] finalize (eval+artifacts) {time.time() - t_phase:.1f}s")
    return results
