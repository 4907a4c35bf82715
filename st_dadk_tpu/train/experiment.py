"""Single-experiment runner: data -> masks -> fit -> eval -> artifacts.

Reproduces the reference's per-experiment pipeline and filesystem contract
(scripts/train_st_interp.py:1936-2633):

    experiments/<i>/
        results.json            full schema incl. per-split metrics & history
        training_history.csv    epoch,train_loss,val_loss,val_rmse,lr
        model_final.npz         final params (best-EMA) — npz instead of .pt
        model_best.npz
        predictions.npz         dense (T,S) field + masks + coords
        basis_info.npz          init/final centers & bandwidths
        *.png                   figure families (viz.plots)

Seeding discipline matches the reference exactly: experiment seed =
base_seed + id - 1; observation mask sampled with that seed; train/valid
split with seed + 10000 (train_st_interp.py:2179-2234) — given the same seed
the masks are bit-identical to the reference's.
"""
from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet, dense_grid_points, pointset_from_mask
from st_dadk_tpu.dataio.kaust import load_kaust_csv_single
from st_dadk_tpu.dataio.obs_design import (
    sample_observations,
    spatial_obs_probs,
    split_train_valid,
)
from st_dadk_tpu.models.st_interp import (
    ModelSpec,
    count_parameters,
    init_model,
    spec_from_config,
)
from st_dadk_tpu.ops.init_centers import init_spatial_centers
from st_dadk_tpu.ops.losses import check_loss_np, compute_crps_multi_quantile
from st_dadk_tpu.train.loop import FitResult, fit, predict
from st_dadk_tpu.utils.io import save_json, write_csv


def _flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def save_params_npz(params: Dict[str, Any], path: Path) -> None:
    np.savez(path, **_flatten_params(params))


def load_params_npz(path: Path) -> Dict[str, Any]:
    flat = np.load(path)
    params: Dict[str, Any] = {}
    for name in flat.files:
        parts = name.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[name]
    return params


def evaluate_pointset(cfg: ExperimentConfig, spec: ModelSpec,
                      params: Dict[str, Any], consts: Dict[str, Any],
                      ps: PointSet) -> Tuple[Dict[str, float], np.ndarray]:
    """Metrics parity with evaluate_model (train_st_interp.py:884-961).

    Returns (metrics dict, raw predictions (n, out_dim))."""
    preds = predict(spec, params, consts, ps.coords, ps.t)
    return metrics_from_preds(cfg, preds, ps.y), preds


def metrics_from_preds(cfg: ExperimentConfig, preds: np.ndarray,
                       trues: np.ndarray) -> Dict[str, float]:
    if cfg.regression_type == "multi-quantile":
        median_idx = len(cfg.quantile_levels) // 2
        preds_m = preds[:, median_idx:median_idx + 1]
    else:
        preds_m = preds

    mse = float(np.mean((preds_m - trues) ** 2))
    metrics = {"mse": mse,
               "mae": float(np.mean(np.abs(preds_m - trues))),
               "rmse": float(np.sqrt(mse))}

    if cfg.regression_type == "quantile" and cfg.current_quantile is not None:
        metrics["check_loss"] = check_loss_np(preds.ravel(), trues.ravel(),
                                              float(cfg.current_quantile))
    if cfg.regression_type == "multi-quantile":
        metrics["crps"] = float(compute_crps_multi_quantile(
            preds, trues, cfg.quantile_levels))
        checks = [check_loss_np(preds[:, i], trues.ravel(), q)
                  for i, q in enumerate(cfg.quantile_levels)]
        metrics["mean_check_loss"] = float(np.mean(checks))
        metrics["check_loss"] = float(np.mean(checks))
    return metrics


def dense_field_prediction(cfg: ExperimentConfig, spec: ModelSpec,
                           params: Dict[str, Any], consts: Dict[str, Any],
                           T: int, coords: np.ndarray) -> np.ndarray:
    """Predict the full (T, S) field; median quantile for multi-quantile
    (parity with plot_spatial_mse's predictions.npz payload,
    train_st_interp.py:1196-1300)."""
    coords_rep, t_rep = dense_grid_points(T, coords)
    preds = predict(spec, params, consts, coords_rep, t_rep)
    if cfg.regression_type == "multi-quantile":
        median_idx = len(cfg.quantile_levels) // 2
        preds = preds[:, median_idx]
    else:
        preds = preds[:, 0]
    return preds.reshape(T, coords.shape[0])


def run_single_experiment(
    config: ExperimentConfig | Dict[str, Any],
    experiment_id: int,
    output_dir: Path,
    verbose: bool = True,
    skip_existing: bool = False,
    mesh=None,
    write_artifacts: bool = True,
) -> Optional[Dict[str, Any]]:
    """Dispatch by regression type (ref run_single_experiment :1936-2161):
    multi-quantile -> one joint model; quantile with multiple levels -> one
    model per tau in quantile_<tau>/ subdirs with CRPS aggregation; otherwise
    a single fit."""
    cfg = (config if isinstance(config, ExperimentConfig)
           else ExperimentConfig.from_dict(config))
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    if skip_existing and (output_dir / "results.json").exists():
        import json
        with open(output_dir / "results.json") as f:
            return json.load(f)

    if cfg.regression_type == "multi-quantile" or \
       cfg.regression_type == "mean" or len(cfg.quantile_levels) <= 1:
        if cfg.regression_type == "quantile" and cfg.current_quantile is None:
            cfg = cfg.replace(current_quantile=cfg.quantile_levels[0])
        return _run_one_fit(cfg, experiment_id, output_dir, verbose,
                            mesh=mesh, write_artifacts=write_artifacts)

    # quantile regression with multiple levels: one model per tau
    quantile_results: Dict[float, Dict[str, Any]] = {}
    quantile_preds: Dict[float, Dict[str, np.ndarray]] = {}
    for q in cfg.quantile_levels:
        q_dir = output_dir / f"quantile_{q}"
        q_dir.mkdir(parents=True, exist_ok=True)
        q_cfg = cfg.replace(regression_type="quantile", current_quantile=q)
        if skip_existing and (q_dir / "results.json").exists() \
                and (q_dir / "predictions.npz").exists():
            import json
            with open(q_dir / "results.json") as f:
                quantile_results[q] = json.load(f)
            pred = np.load(q_dir / "predictions.npz")
            preds = pred["predictions"]
            quantile_preds[q] = {
                "train": preds[pred["train_mask"]],
                "test": preds[pred["test_mask"]],
                "valid": preds[pred["valid_mask"]],
                "train_true": pred["true"][pred["train_mask"]],
                "test_true": pred["true"][pred["test_mask"]],
                "valid_true": pred["true"][pred["valid_mask"]],
            }
            continue
        r = _run_one_fit(q_cfg, experiment_id, q_dir, verbose, mesh=mesh,
                         write_artifacts=write_artifacts)
        quantile_results[q] = r
        quantile_preds[q] = r.pop("_split_predictions")

    qs = list(cfg.quantile_levels)
    from st_dadk_tpu.ops.losses import compute_crps
    crps = {}
    for split in ("train", "test", "valid"):
        preds_dict = {q: quantile_preds[q][split] for q in qs}
        y_true = quantile_preds[qs[0]][f"{split}_true"]
        crps[split] = compute_crps(preds_dict, y_true)

    mean_of = lambda key: float(np.mean(
        [quantile_results[q].get(key, quantile_results[q].get(
            key.replace("check_loss", "mse"), 0.0)) for q in qs]))
    total_time = float(np.sum(
        [quantile_results[q].get("total_time_seconds", 0) for q in qs]))

    aggregated = {
        "experiment_id": experiment_id,
        "regression_type": "quantile",
        "quantile_levels": qs,
        "quantile_results": quantile_results,
        "train_crps": float(crps["train"]),
        "test_crps": float(crps["test"]),
        "valid_crps": float(crps["valid"]),
        "train_check_loss": mean_of("train_check_loss"),
        "test_check_loss": mean_of("test_check_loss"),
        "valid_check_loss": mean_of("valid_check_loss"),
        "test_mse": mean_of("test_check_loss"),
        "valid_mse": mean_of("valid_check_loss"),
        "train_mse": mean_of("train_check_loss"),
        "test_rmse": float(np.sqrt(mean_of("test_check_loss"))),
        "valid_rmse": float(np.sqrt(mean_of("valid_check_loss"))),
        "train_rmse": float(np.sqrt(mean_of("train_check_loss"))),
        "test_mae": mean_of("test_mae"),
        "valid_mae": mean_of("valid_mae"),
        "train_mae": mean_of("train_mae"),
        "total_time_seconds": total_time,
    }
    if write_artifacts:
        save_json(aggregated, output_dir / "results.json")

    # combined fan chart across the separate per-tau models' dense fields
    # (ref reloads per-tau checkpoints for this, :2094-2150; the stored
    # predictions.npz fields are those models' deterministic outputs)
    if cfg.save_plots and cfg.save_artifacts and write_artifacts:
        try:
            from st_dadk_tpu.viz.plots import plot_combined_quantile_series
            qpred, z_full = {}, None
            for q in qs:
                f = output_dir / f"quantile_{q}" / "predictions.npz"
                if f.exists():
                    d = np.load(f)
                    qpred[q] = d["predictions"]
                    z_full, coords = d["true"], d["coords"]
                    train_mask, test_mask = d["train_mask"], d["test_mask"]
            if len(qpred) == len(qs) and z_full is not None:
                plot_combined_quantile_series(qpred, z_full, coords,
                                              train_mask, test_mask,
                                              output_dir)
        except Exception as e:
            print(f"[WARNING] combined quantile plot failed: {e}")
    return aggregated


class ExperimentSetup:
    """Everything a fit needs, prepared on host (masks are seed-exact with
    the reference; see module docstring)."""

    # construction counter: the pod streaming-setup guarantee ("each process
    # synthesizes only its own lanes", batch_engine._prepare_job_batch) is
    # asserted against this in tests/mp_cluster_worker.py
    n_constructed = 0

    def __init__(self, cfg: ExperimentConfig, experiment_id: int,
                 verbose: bool = False, defer_model: bool = False):
        ExperimentSetup.n_constructed += 1
        self.experiment_id = experiment_id
        self.experiment_seed = cfg.base_seed + experiment_id - 1
        np.random.seed(self.experiment_seed)

        self.z_full, self.coords, self.metadata = _load_cached(
            cfg.resolve_data_file(), cfg.normalize_target, verbose)
        self.T, self.S = self.z_full.shape

        obs_weights = spatial_obs_probs(self.coords, cfg.obs_spatial_pattern,
                                        cfg.obs_spatial_intensity)
        self.obs_mask, obs_sites = sample_observations(
            self.z_full, self.coords, cfg.obs_method, cfg.obs_ratio,
            obs_weights, seed=self.experiment_seed)
        self.train_mask, self.valid_mask = split_train_valid(
            self.obs_mask, obs_sites, cfg.split_method, cfg.train_ratio,
            seed=self.experiment_seed + 10000)
        self.test_mask = ~self.obs_mask

        self.train_ps = pointset_from_mask(self.z_full, self.coords,
                                           self.train_mask)
        self.valid_ps = pointset_from_mask(self.z_full, self.coords,
                                           self.valid_mask)
        self.test_ps = pointset_from_mask(self.z_full, self.coords,
                                          self.test_mask)

        self.spec = spec_from_config(cfg)
        self.cfg = cfg
        self.params = None
        self.consts = None
        # global numpy RNG state at this point (after the seeded mask draws).
        # The sequential engine's data-adaptive init subsamples from this
        # stream; the batch engine restores it per lane so both engines
        # produce identical inits (round-1 review: engine-dependent RNG).
        self.np_rng_state = np.random.get_state()
        if not defer_model:
            train_coords = None
            from st_dadk_tpu.ops.init_centers import (
                DATA_ADAPTIVE_INIT_METHODS)
            if cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS:
                train_coords = self.train_ps.coords
            centers, bandwidths = init_spatial_centers(
                cfg.spatial_init_method, cfg.k_spatial_centers, train_coords,
                key=jax.random.PRNGKey(self.experiment_seed),
                em_dtype=cfg.extra.get("init_em_dtype"),
                gmm_n_init=cfg.extra.get("init_gmm_n_init"),
                subsample=cfg.extra.get("init_subsample"),
                seed_rounds=cfg.extra.get("init_seed_rounds"),
                gmm_fused=bool(cfg.extra.get("init_gmm_fused", False)))
            self.finish_model(centers, bandwidths)

    def finish_model(self, centers, bandwidths) -> None:
        """Instantiate params/consts from (possibly batch-computed) centers.

        Ragged-k stacking (cfg.k_spatial_pad): params draw at the lane's REAL
        shapes — same values as an unpadded sequential run — then pad to the
        shared program width (models.st_interp.pad_lane_model)."""
        import dataclasses

        from st_dadk_tpu.models.st_interp import pad_lane_model

        cfg = self.cfg
        if cfg.k_spatial_pad is None:
            self.params, self.consts = init_model(
                jax.random.PRNGKey(self.experiment_seed), self.spec,
                centers, bandwidths)
            return
        spec_real = dataclasses.replace(
            self.spec, k_spatial_centers=tuple(cfg.k_spatial_centers))
        params, consts = init_model(
            jax.random.PRNGKey(self.experiment_seed), spec_real,
            centers, bandwidths)
        self.params, self.consts = pad_lane_model(
            spec_real, int(cfg.k_spatial_pad), params, consts)


_CSV_CACHE: Dict[Tuple[str, bool], Tuple[np.ndarray, np.ndarray, Dict]] = {}


def _load_cached(path: Path, normalize: bool, verbose: bool):
    """Load-once cache: the reference re-reads and re-densifies the CSV for
    every experiment repeat (train_st_interp.py:2187); repeats here share one
    parse."""
    key = (str(path), bool(normalize))
    if key not in _CSV_CACHE:
        _CSV_CACHE[key] = load_kaust_csv_single(path, normalize=normalize,
                                                verbose=verbose)
    return _CSV_CACHE[key]


def _run_one_fit(cfg: ExperimentConfig, experiment_id: int, output_dir: Path,
                 verbose: bool = True, mesh=None,
                 write_artifacts: bool = True) -> Dict[str, Any]:
    """One fit end-to-end (ref _run_single_quantile_experiment :2164-2633).

    With `mesh`, the fit is data-parallel over the mesh's 'data' axis
    (see st_dadk_tpu.train.loop.fit)."""
    start_time = time.time()
    setup = ExperimentSetup(cfg, experiment_id, verbose)
    t_setup = time.time() - start_time
    if verbose:
        print(f"[EXP {experiment_id}] seed={setup.experiment_seed} "
              f"data={cfg.data_file} type={cfg.regression_type} "
              f"train/valid/test: {setup.train_ps.n_real}/"
              f"{setup.valid_ps.n_real}/{setup.test_ps.n_real}")

    t0 = time.time()
    result: FitResult = fit(cfg, setup.spec, setup.params, setup.consts,
                            setup.train_ps, setup.valid_ps,
                            seed=setup.experiment_seed, verbose=verbose,
                            mesh=mesh)
    t_train = time.time() - t0
    total_time = time.time() - start_time
    return finalize_experiment(cfg, setup, result, output_dir, total_time,
                               verbose=verbose,
                               stage_timings={"setup_seconds": t_setup,
                                              "train_seconds": t_train},
                               write_artifacts=write_artifacts)


def _tensor_stats(arr: np.ndarray) -> Dict[str, Any]:
    a = np.asarray(arr, np.float64)
    finite = np.isfinite(a)
    fa = a[finite]
    return {
        "shape": list(a.shape),
        "n_nonfinite": int((~finite).sum()),
        "min": float(fa.min()) if fa.size else None,
        "max": float(fa.max()) if fa.size else None,
        "mean": float(fa.mean()) if fa.size else None,
        "std": float(fa.std()) if fa.size else None,
    }


def _write_nan_diagnostics(output_dir: Path, result: FitResult,
                           setup: "ExperimentSetup",
                           nan_epochs: np.ndarray) -> None:
    """Postmortem dump after NaN-poisoned epochs (ref train_st_interp.py
    :723-733 prints loss/param/input statistics at the NaN step; the jitted
    loop poisons the step ON DEVICE and continues, so this reconstructs the
    host-visible equivalent at finalize: which epochs poisoned, per-leaf
    statistics of the final and serving params, and training-input stats.
    Per-step gradient stats are not observable from outside the compiled
    scan; the poisoned epochs' loss values in training_history.csv plus the
    param drift between serving (pre-NaN best) and final params localize the
    blow-up in practice."""
    flat_params: Dict[str, Any] = {}

    def walk(tree, prefix, into):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.", into)
        else:
            into[prefix[:-1]] = _tensor_stats(np.asarray(tree))

    walk(result.params, "serving_params.", flat_params)
    walk(result.final_ema, "final_ema.", flat_params)
    diag = {
        "nan_epochs": nan_epochs.tolist(),
        "n_epochs_run": int(result.n_epochs_run),
        "train_loss_tail": np.asarray(
            result.history["train_loss"])[-10:].tolist(),
        "val_loss_tail": np.asarray(
            result.history["val_loss"])[-10:].tolist(),
        "inputs": {
            "train_y": _tensor_stats(setup.train_ps.y),
            "train_coords": _tensor_stats(setup.train_ps.coords),
            "train_t": _tensor_stats(setup.train_ps.t),
        },
        "params": flat_params,
    }
    save_json(diag, output_dir / "nan_diagnostics.json")


def finalize_experiment(cfg: ExperimentConfig, setup: "ExperimentSetup",
                        result: FitResult, output_dir: Path,
                        total_time: float, verbose: bool = False,
                        stage_timings: Optional[Dict[str, float]] = None,
                        precomputed: Optional[Dict[str, Any]] = None,
                        write_artifacts: bool = True,
                        steps_per_epoch: Optional[int] = None) -> Dict[str, Any]:
    """Evaluation + results.json + artifacts + plots for one completed fit.

    `write_artifacts=False` computes everything (metrics, split
    predictions) but performs NO filesystem writes — used by lockstep
    multi-process fits (engine='dp' on a pod) where every process computes
    identical results and only the primary may write."""
    t_eval_start = time.time()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    experiment_id = setup.experiment_id
    experiment_seed = setup.experiment_seed
    spec = setup.spec
    consts = setup.consts
    z_full, coords, T = setup.z_full, setup.coords, setup.T
    train_mask, valid_mask, test_mask = (setup.train_mask, setup.valid_mask,
                                         setup.test_mask)
    train_ps, valid_ps, test_ps = setup.train_ps, setup.valid_ps, setup.test_ps
    obs_mask = setup.obs_mask

    if cfg.k_spatial_pad is not None:
        # ragged-k lane: strip the shared-program padding so every artifact
        # (results.json n_parameters, model npz, basis_info, plots) carries
        # the lane's REAL shapes (models.st_interp.strip_lane_padding)
        import dataclasses as _dc

        from st_dadk_tpu.models.st_interp import strip_lane_padding
        spec_real = _dc.replace(
            spec, k_spatial_centers=tuple(cfg.k_spatial_centers))
        k_pad = int(cfg.k_spatial_pad)
        p_real, consts = strip_lane_padding(spec_real, k_pad,
                                            result.params, consts)
        e_real, _ = strip_lane_padding(spec_real, k_pad,
                                       result.final_ema, setup.consts)
        result = result._replace(
            params=p_real, final_ema=e_real,
            centers_history=[(e, np.asarray(c)[:spec_real.k_spatial])
                             for e, c in result.centers_history])
        spec = spec_real
        n_params = count_parameters(p_real)
    else:
        n_params = getattr(setup, "n_params", None)
        if n_params is None:
            n_params = count_parameters(setup.params)

    init_centers_np = np.asarray(consts["spatial_centers_init"])
    init_bw_np = np.asarray(consts["spatial_bandwidths_init"])

    history = {
        "train_loss": result.history["train_loss"].tolist(),
        "val_loss": result.history["val_loss"].tolist(),
        "val_rmse": result.history["val_rmse"].tolist(),
        "lr": result.history["lr"].tolist(),
    }

    # -- evaluation ---------------------------------------------------------------
    if precomputed is not None:
        train_metrics = precomputed["train_metrics"]
        val_metrics = precomputed["val_metrics"]
        test_metrics = precomputed["test_metrics"]
    else:
        train_metrics, _ = evaluate_pointset(cfg, spec, result.params, consts,
                                             train_ps)
        val_metrics, _ = evaluate_pointset(cfg, spec, result.params, consts,
                                           valid_ps)
        test_metrics, _ = evaluate_pointset(cfg, spec, result.params, consts,
                                            test_ps)
    if verbose:
        print(f"  test: {test_metrics}")

    config_with_dir = cfg.to_dict()
    config_with_dir["output_dir"] = str(output_dir)

    results: Dict[str, Any] = {
        "experiment_id": experiment_id,
        "experiment_seed": experiment_seed,
        "config": config_with_dir,
        "metrics": {"train": train_metrics, "valid": val_metrics,
                    "test": test_metrics},
        "training_history": history,
        "total_time_seconds": total_time,
        "total_time_formatted": (f"{int(total_time//3600):02d}:"
                                 f"{int((total_time%3600)//60):02d}:"
                                 f"{int(total_time%60):02d}"),
        "model_parameters": n_params,
        "timestamp": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "n_epochs_run": result.n_epochs_run,
        # observability beyond the reference's single wall-clock figure
        # (SURVEY.md section 5.1): per-stage timings + training throughput
        "stage_timings": dict(stage_timings or {}),
    }
    results["stage_timings"]["eval_seconds"] = time.time() - t_eval_start
    train_s = results["stage_timings"].get("train_seconds")
    if train_s:
        if steps_per_epoch is None:
            # sequential engine: recompute the loop's own batching. Batched
            # engines pass the shared program's actual steps_per_epoch
            # (B_shared from the min-lane batch size), which can differ for
            # heterogeneous lane sizes.
            from st_dadk_tpu.train.loop import adaptive_batch_size
            bs = adaptive_batch_size(train_ps.n_real, cfg.batch_size)
            steps_per_epoch = max(1, -(-train_ps.n_real // bs))
        results["steps_per_second"] = (result.n_epochs_run * steps_per_epoch
                                       / train_s)
    for split, m in (("train", train_metrics), ("valid", val_metrics),
                     ("test", test_metrics)):
        results[f"{split}_mse"] = m["mse"]
        results[f"{split}_mae"] = m["mae"]
        results[f"{split}_rmse"] = m["rmse"]

    if cfg.regression_type == "quantile":
        results["regression_type"] = "quantile"
        results["quantile_level"] = cfg.current_quantile
        for split, m in (("train", train_metrics), ("valid", val_metrics),
                         ("test", test_metrics)):
            results[f"{split}_check_loss"] = m.get("check_loss", m["mse"])
        # ref :2622-2625: check loss replaces mse in flat keys
        results["test_mse"] = test_metrics.get("check_loss", test_metrics["mse"])
        results["valid_mse"] = val_metrics.get("check_loss", val_metrics["mse"])
    elif cfg.regression_type == "multi-quantile":
        results["regression_type"] = "multi-quantile"
        results["quantile_levels"] = list(cfg.quantile_levels)
        for split, m in (("train", train_metrics), ("valid", val_metrics),
                         ("test", test_metrics)):
            results[f"{split}_crps"] = m["crps"]
            results[f"{split}_check_loss"] = m["mean_check_loss"]

    nan_epochs = np.flatnonzero(~np.isfinite(
        np.asarray(result.history["train_loss"], np.float64)))
    if nan_epochs.size and write_artifacts:
        # NaN postmortem (ref train_st_interp.py:723-733 dumps tensor stats
        # when a NaN loss poisons a step; here the poison/skip happens on
        # device, so the host dumps the state it can see on chunk exit)
        _write_nan_diagnostics(output_dir, result, setup, nan_epochs)
        if verbose:
            print(f"[WARNING] NaN train loss in epochs "
                  f"{nan_epochs.tolist()}; diagnostics -> "
                  f"{output_dir / 'nan_diagnostics.json'}")

    if write_artifacts:
        save_json(results, output_dir / "results.json")

        write_csv(output_dir / "training_history.csv", {
            "epoch": list(range(1, len(history["train_loss"]) + 1)),
            "train_loss": history["train_loss"],
            "val_loss": history["val_loss"],
            "val_rmse": history["val_rmse"],
            "lr": history["lr"],
        })

    # -- artifacts ------------------------------------------------------------
    split_predictions = None
    all_predictions = (precomputed or {}).get("all_predictions")
    if cfg.save_artifacts and write_artifacts:
        save_params_npz(result.params, output_dir / "model_final.npz")
        save_params_npz(result.params, output_dir / "model_best.npz")

        if all_predictions is None:
            all_predictions = dense_field_prediction(cfg, spec, result.params,
                                                     consts, T, coords)
        np.savez(output_dir / "predictions.npz",
                 predictions=all_predictions, true=z_full, coords=coords,
                 train_mask=train_mask, valid_mask=valid_mask,
                 test_mask=test_mask)

        final_centers, final_bw = _final_basis(spec, result.params,
                                               init_centers_np, init_bw_np)
        np.savez(output_dir / "basis_info.npz",
                 spatial_centers_init=init_centers_np,
                 spatial_centers_final=final_centers,
                 spatial_bandwidths_init=init_bw_np,
                 spatial_bandwidths_final=final_bw,
                 temporal_centers_init=np.asarray(consts["temporal_centers"]),
                 temporal_centers_final=np.asarray(consts["temporal_centers"]),
                 temporal_bandwidths_init=np.asarray(consts["temporal_bandwidths"]),
                 temporal_bandwidths_final=np.asarray(consts["temporal_bandwidths"]))

    # split predictions feed the separate-models-per-tau CRPS aggregation,
    # which runs regardless of save_artifacts — compute them for quantile
    # fits even when artifacts are off (the dense field is cheap relative
    # to the fit)
    if cfg.save_artifacts or cfg.regression_type == "quantile":
        if all_predictions is None:
            all_predictions = dense_field_prediction(cfg, spec, result.params,
                                                     consts, T, coords)
        split_predictions = {
            "train": all_predictions[train_mask],
            "test": all_predictions[test_mask],
            "valid": all_predictions[valid_mask],
            "train_true": z_full[train_mask],
            "test_true": z_full[test_mask],
            "valid_true": z_full[valid_mask],
        }

    if cfg.save_plots and write_artifacts:
        try:
            from st_dadk_tpu.viz import plots
            plots.plot_training_curves(history, output_dir / "training_curves.png")
            plots.plot_observation_pattern(coords, obs_mask, train_mask,
                                           valid_mask, output_dir)
            plots.plot_predictions(cfg, spec, result.params, consts, z_full,
                                   coords, train_mask, output_dir)
            if all_predictions is None:
                all_predictions = dense_field_prediction(
                    cfg, spec, result.params, consts, T, coords)
            plots.plot_spatial_mse(z_full, coords, all_predictions,
                                   train_mask, output_dir)
            plots.plot_temporal_series(cfg, spec, result.params, consts,
                                       z_full, coords, train_mask, valid_mask,
                                       test_mask, output_dir)
            inactive = plots.inactive_basis_mask(
                np.asarray(result.params["mlp"]["linear_0"]["w"]),
                spec.k_spatial, spec.p, cfg.sparsity_threshold_ratio)
            plots.plot_basis_evolution(init_centers_np, init_bw_np,
                                       *_final_basis(spec, result.params,
                                                     init_centers_np, init_bw_np),
                                       train_ps.coords, output_dir,
                                       result.centers_history,
                                       inactive=inactive)
        except Exception as e:  # plots must never fail an experiment
            print(f"[WARNING] plotting failed: {e}")

    if verbose:
        print(f"[EXP {experiment_id}] done in "
              f"{results['total_time_formatted']} -> {output_dir}")

    if split_predictions is not None:
        # used by the separate-models-per-tau CRPS aggregation; stripped
        # before JSON persistence
        results["_split_predictions"] = split_predictions
    return results


def _final_basis(spec: ModelSpec, params: Dict[str, Any],
                 init_centers: np.ndarray, init_bw: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if spec.spatial_learnable:
        return (np.asarray(params["basis"]["centers"]),
                np.exp(np.asarray(params["basis"]["log_bandwidths"])))
    return init_centers, init_bw

