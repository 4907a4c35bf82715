"""Typed experiment configuration with centralized defaults.

The reference scatters defaults through ~45 `config.get(key, default)` call
sites on a flat YAML dict (ref: configs/config_st_interp.yaml:1-85 and e.g.
scripts/train_st_interp.py:467-561,2179-2293). Here every known key is a typed
dataclass field whose default equals the reference *code* default, and YAML /
CLI overrides are applied on top — so an effective config is always fully
specified and serializable.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ExperimentConfig:
    # -- experiment identity --------------------------------------------------
    tag: str = "default"
    data_file: str = "data/2b/2b_7.csv"
    n_experiments: int = 10
    base_seed: int = 42
    n_jobs: int = 10              # kept for config compatibility (joblib knob in ref)
    num_workers: int = 0          # no dataloader workers; kept for compat
    device: str = "gpu"           # informational only; JAX picks the backend
    config_id: Optional[int] = None  # set by grid-search tagging

    # -- model architecture ---------------------------------------------------
    k_spatial_centers: List[int] = field(default_factory=lambda: [25, 81, 121])
    k_temporal_centers: List[int] = field(default_factory=lambda: [10, 15, 45])
    spatial_basis_function: str = "wendland"   # wendland | gaussian | triangular
    spatial_init_method: str = "uniform"       # uniform | gmm | random_site | kmeans_balanced | kmeans_exact
    spatial_learnable: bool = False
    hidden_dims: List[int] = field(default_factory=lambda: [256, 256, 128])
    dropout: float = 0.1
    layernorm: bool = True
    p_covariates: int = 0
    use_delta_reparameterization: bool = False

    # -- learnable-basis control ----------------------------------------------
    gradient_damping: bool = False
    damping_threshold: float = 0.3
    damping_strength: float = 1.0
    domain_penalty_weight: float = 0.0
    movement_penalty_weight: float = 0.0
    basis_lr_ratio: float = 0.05
    basis_unfreeze_epoch: int = 0
    basis_lr_rampup_epochs: int = 0

    # -- sparsity penalty ------------------------------------------------------
    sparsity_penalty_type: str = "none"        # none | element | group | sparse_group
    sparsity_lambda_l1: float = 0.001
    sparsity_lambda_group: float = 0.01
    sparsity_apply_to_spatial: bool = True
    sparsity_apply_to_temporal: bool = True
    sparsity_threshold_ratio: float = 0.01

    # -- non-crossing penalty (multi-quantile) ---------------------------------
    non_crossing_weight: float = 0.0
    non_crossing_power: int = 1
    non_crossing_lambda: float = 0.0
    # P_nc(delta) sign convention. "eq310" adds lambda * P_nc(delta) exactly as
    # the reference does (train_st_interp.py:634-651) — NOTE this rewards ever
    # more negative P_nc and measurably runs away (losses -> -inf; verified on
    # both frameworks; the reference's own docstring flags the risk at :100-110).
    # "abs" adds lambda * (-P_nc(delta)) >= 0, penalizing infeasibility as the
    # reference's TODO suggests.
    non_crossing_delta_mode: str = "eq310"

    # -- observation design ----------------------------------------------------
    obs_method: str = "site-wise"              # site-wise | random
    obs_ratio: float = 0.5
    obs_spatial_pattern: str = "uniform"       # uniform | corner
    obs_spatial_intensity: float = 1.0
    split_method: str = "site-wise"            # site-wise | random
    train_ratio: float = 0.8
    normalize_target: bool = False

    # -- training ----------------------------------------------------------------
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 256
    patience: int = 15
    # Plateau-slope stop (opt-in, default OFF = exact reference semantics).
    # With a value d > 0, the patience counter resets only on SIGNIFICANT
    # improvement — val_loss < anchor - d*|anchor|, where the anchor is the
    # last significant value — so a lane whose validation keeps improving by
    # less than d per patience-window stops after `patience` epochs instead
    # of training to the epoch cap (the mixed-grid critical path: smooth
    # fields like 2a_9 improve genuinely-but-marginally for 500 epochs).
    # Equivalent per-epoch slope
    # threshold: d / patience. best-EMA checkpointing still tracks the TRUE
    # best on any improvement; only the stop decision is thresholded. At 0.0
    # the criterion reduces bit-exactly to the reference's any-improvement
    # patience. Accuracy-affecting when on.
    early_stop_min_rel_delta: float = 0.0
    grad_clip: float = 0.0
    scheduler: Optional[str] = None            # None | 'cosine'
    warmup_epochs: int = 0

    # -- regression head ---------------------------------------------------------
    regression_type: str = "mean"              # mean | quantile | multi-quantile
    quantile_levels: List[float] = field(default_factory=lambda: [0.1, 0.5, 0.9])
    current_quantile: Optional[float] = None

    # -- framework extras (no reference equivalent) ------------------------------
    data_root: Optional[str] = None            # prefix for relative data_file paths
    dropout_rng: str = "rbg"                   # dropout mask generator: 'rbg'
                                               # (lax.rng_bit_generator; Philox
                                               # on GPU) or 'threefry' (the jax
                                               # default, round-1 streams).
                                               # Which is faster on the GPU is
                                               # open (ROADMAP Speed item 6)
    mesh_axis: str = "exp"                     # mesh axis name for the experiment batch
    packed_optimizer: bool = False             # run AdamW/EMA/clip on flat-packed param
                                               # groups inside the epoch scan (opt-in;
                                               # unmeasured on the GPU, ROADMAP Design
                                               # item 3)
    scan_unroll: int = 1                       # lax.scan unroll factor for the per-epoch
                                               # batch-step loop (larger scheduling blocks)
    train_dtype: str = "auto"                  # trunk activation dtype in training:
                                               # 'bf16' halves the activation traffic
                                               # (params, LN stats, losses, optimizer
                                               # stay f32). 'auto' (default) flips to
                                               # bf16 for wide lane batches (batch_engine.
                                               # AUTO_BF16_LANES) and wide MLPs
                                               # (st_interp.AUTO_BF16_HIDDEN_SUM); f32
                                               # elsewhere. Both switch points await GPU
                                               # measurements (ROADMAP Speed items 3, 5)
    k_spatial_pad: Optional[int] = None        # ragged-k lane stacking (SURVEY §7.1
                                               # step 6): pad this config's spatial basis
                                               # to k_spatial_pad total centers so grid
                                               # configs with different k_spatial_centers
                                               # share ONE vmapped program. Real centers
                                               # occupy the first sum(k_spatial_centers)
                                               # rows; junk rows are zero-initialized and
                                               # masked out of phi (consts
                                               # 'spatial_k_mask'), so each lane's fit
                                               # tracks its own-shape sequential run.
    tail_compaction: bool = False              # batch engine: after compaction_epoch, gather
                                               # still-active lanes into a narrower vmapped
                                               # program so early-stopped lanes stop costing
                                               # compute (results unchanged; lanes are
                                               # independent and stopped carries are frozen).
                                               # OFF by default (opt-in for much wider
                                               # lane batches)
    compaction_epoch: int = 100                # full-width epochs before the first compaction
    save_plots: bool = True
    save_artifacts: bool = True                # predictions.npz / basis_info.npz / checkpoints
    eval_chunk: int = 32768                    # chunk size for dense-grid inference

    # Unknown keys found in YAML are preserved here so config snapshots round-trip.
    # Recognized experimental keys (opt-in cost knobs, A/B'd via
    # scripts/ab_paired.py before any default flips):
    #   init_em_dtype:   'bfloat16' stores the GMM EM (n,k) tensors in bf16
    #   init_gmm_n_init: override the GMM's k-means++ restart count (ref: 3)
    #   init_subsample:  override the data-adaptive init subsample cap (ref:
    #                    10_000; smaller = cheaper EM, different np stream)
    #   init_seed_rounds: R swaps exact sequential k-means++ seeding for the
    #                    R-round batched draw (kmeans_plus_plus_rounds) —
    #                    sequential depth k-1 -> R
    #   init_gmm_fused:  true merges all basis resolutions' GMM EMs into ONE
    #                    concat-k while_loop (gmm_spherical_multi: zero
    #                    padding, per-resolution tol freeze; seeding stream
    #                    identical, EM trajectories differ within tol)
    #   shuffle:         'perm' restores the sort-based epoch permutation
    #   remat:           true rematerializes the training forward in the
    #                    backward (jax.checkpoint) — smaller per-step working
    #                    set for wide lane batches at ~1/3 more matmul FLOPs
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "extra"}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for k, v in d.items():
            if k in known:
                kwargs[k] = v
            else:
                extra[k] = v
        cfg = cls(**kwargs)
        cfg.extra = extra
        # YAML often stores scientific-notation floats as strings (ref reads
        # them with float(...) at each use site, train_st_interp.py:475,484).
        cfg.lr = float(cfg.lr)
        cfg.weight_decay = float(cfg.weight_decay)
        return cfg

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ExperimentConfig":
        import yaml
        with open(path, "r", encoding="utf-8") as f:
            d = yaml.safe_load(f) or {}
        return cls.from_dict(d)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d

    def to_yaml(self, path: str | Path) -> None:
        import yaml
        with open(path, "w", encoding="utf-8") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False)

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    # -- derived quantities ------------------------------------------------------
    def resolve_data_file(self) -> Path:
        """Resolve the data file against data_root, the CWD, and the
        repository root."""
        p = Path(self.data_file)
        if p.is_absolute():
            return p
        roots = []
        if self.data_root:
            roots.append(Path(self.data_root))
        roots += [Path.cwd(), Path(__file__).resolve().parent.parent]
        for root in roots:
            cand = root / p
            if cand.exists():
                return cand
        return p

    @property
    def output_dim(self) -> int:
        if self.regression_type == "multi-quantile":
            return len(self.quantile_levels)
        return 1

    def json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def load_config(path: str | Path, overrides: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    cfg = ExperimentConfig.from_yaml(path)
    if overrides:
        clean = {k: v for k, v in overrides.items() if v is not None}
        known = {f.name for f in dataclasses.fields(ExperimentConfig)}
        cfg = cfg.replace(**{k: v for k, v in clean.items() if k in known})
        for k, v in clean.items():
            if k not in known:
                cfg.extra[k] = v
    return cfg
