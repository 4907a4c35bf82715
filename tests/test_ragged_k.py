"""Ragged-k lane stacking (SURVEY §7.1 step 6): grid configs with different
k_spatial_centers share ONE padded vmapped program (cfg.k_spatial_pad +
models.st_interp.pad_lane_model). Per-lane results must track the same
config's own-shape run — padding only adds exact zeros to the matmul
reductions, so metrics agree to f32 tolerance and the padded rows stay at
exactly zero throughout training."""
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.models.st_interp import (
    ModelSpec,
    forward,
    init_model,
    pad_lane_model,
    strip_lane_padding,
)
from st_dadk_tpu.train.batch_engine import run_job_batch, stacking_key
from st_dadk_tpu.train.experiment import run_single_experiment


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return tmp_path


def _cfg(tmp_path, **kw):
    base = dict(
        tag="raggedtest",
        data_file=str(tmp_path / "toy.csv"),
        k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=6, lr=5e-3,
        batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
        grad_clip=10.0, regression_type="mean",
        spatial_learnable=True, gradient_damping=True,
        damping_threshold=0.0, damping_strength=5.0,
        domain_penalty_weight=0.01, movement_penalty_weight=0.001,
        sparsity_penalty_type="sparse_group", sparsity_lambda_l1=1e-4,
        sparsity_lambda_group=1e-4,
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8,
        n_experiments=1, base_seed=100,
        save_plots=False, save_artifacts=True,
    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


class TestPadLaneModel:
    def test_pad_strip_roundtrip(self):
        spec = ModelSpec(k_spatial_centers=(9, 16), k_temporal_centers=(4,),
                         hidden_dims=(8,), spatial_learnable=True)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        padded, pconsts = pad_lane_model(spec, 40, params, consts)
        assert padded["basis"]["centers"].shape == (40, 2)
        assert padded["mlp"]["linear_0"]["w"].shape == (40 + 4, 8)
        assert pconsts["spatial_k_mask"].shape == (40,)
        assert float(pconsts["spatial_k_mask"].sum()) == 25
        stripped, sconsts = strip_lane_padding(spec, 40, padded, pconsts)
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(stripped)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert "spatial_k_mask" not in sconsts

    def test_padded_forward_matches_real(self):
        """phi masking + zero junk rows => identical predictions."""
        spec = ModelSpec(k_spatial_centers=(9,), k_temporal_centers=(4,),
                         hidden_dims=(8,), spatial_learnable=True)
        params, consts = init_model(jax.random.PRNGKey(1), spec)
        k_pad = 24
        padded, pconsts = pad_lane_model(spec, k_pad, params, consts)
        import dataclasses
        spec_pad = dataclasses.replace(spec, k_spatial_centers=(k_pad,))
        coords = jnp.asarray(np.random.default_rng(2).uniform(size=(17, 2)),
                             jnp.float32)
        t = jnp.linspace(0, 1, 17).reshape(-1, 1)
        y_real = forward(spec, params, consts, None, coords, t)
        y_pad = forward(spec_pad, padded, pconsts, None, coords, t)
        np.testing.assert_allclose(np.asarray(y_real), np.asarray(y_pad),
                                   rtol=1e-5, atol=1e-6)


class TestRaggedStacking:
    def test_stacking_key_merges_with_pad(self, toy_csv):
        a = _cfg(toy_csv, k_spatial_centers=[9], k_spatial_pad=25)
        b = _cfg(toy_csv, k_spatial_centers=[16, 9], k_spatial_pad=25)
        assert stacking_key(a) == stacking_key(b)
        c = _cfg(toy_csv, k_spatial_centers=[16, 9])
        assert stacking_key(a) != stacking_key(c)

    def test_stacking_key_splits_on_extra_knobs(self, toy_csv):
        """cfg.extra knobs change the compiled init/epoch program and the
        engine reads them from a bucket's FIRST config — configs differing
        only in an extra knob must NOT share a bucket (regression: a grid
        sweeping init_em_dtype collapsed both arms onto one value)."""
        a = _cfg(toy_csv)
        b = _cfg(toy_csv)
        b.extra = {"init_em_dtype": "bfloat16"}
        assert stacking_key(a) != stacking_key(b)
        c = _cfg(toy_csv)
        c.extra = {"init_em_dtype": "bfloat16"}
        assert stacking_key(b) == stacking_key(c)
        # observation-design fields still stack
        d = _cfg(toy_csv, obs_ratio=0.3)
        assert stacking_key(a) == stacking_key(d)

    def test_ragged_batch_matches_own_shape_runs(self, toy_csv, tmp_path):
        """Two configs with different k as stacked padded lanes vs the same
        configs run unpadded (sequential engine): metrics within f32
        tolerance; artifacts carry REAL shapes; junk rows exactly zero."""
        k_lists = ([9], [16, 9])
        k_pad = max(sum(k) for k in k_lists)

        seq_metrics = []
        for j, kl in enumerate(k_lists):
            cfg = _cfg(toy_csv, k_spatial_centers=list(kl))
            out = tmp_path / f"seq{j}"
            r = run_single_experiment(cfg, 1, out, verbose=False)
            seq_metrics.append(r)

        jobs = []
        for j, kl in enumerate(k_lists):
            cfg = _cfg(toy_csv, k_spatial_centers=list(kl),
                       k_spatial_pad=k_pad)
            jobs.append((cfg, 1, tmp_path / f"stack{j}"))
        stacked = run_job_batch(jobs, verbose=False, epochs_chunk=6)
        assert len(stacked) == 2

        for j, kl in enumerate(k_lists):
            with open(tmp_path / f"stack{j}" / "results.json") as f:
                rs = json.load(f)
            rq = seq_metrics[j]
            # same-shape dynamics track to f32 tolerance (the padded matmul
            # only adds exact-zero terms; reduction order may differ)
            for key in ("test_rmse", "valid_rmse", "train_rmse"):
                assert abs(rs[key] - rq[key]) < 5e-3, \
                    f"{key} diverged for lane {j}: {rs[key]} vs {rq[key]}"
            # n_parameters reports the REAL model size
            assert rs["model_parameters"] == rq["model_parameters"]
            # artifacts carry real-shape basis arrays
            info = np.load(tmp_path / f"stack{j}" / "basis_info.npz")
            assert info["spatial_centers_final"].shape[0] == sum(kl)

    def test_junk_rows_stay_zero(self, toy_csv, tmp_path):
        """The padded rows of a trained lane are exactly zero (wd scaling of
        zero is zero; masked phi blocks every gradient path)."""
        kl = [9]
        k_pad = 25
        cfg = _cfg(toy_csv, k_spatial_centers=kl, k_spatial_pad=k_pad)
        from st_dadk_tpu.train.experiment import ExperimentSetup
        from st_dadk_tpu.train.loop import fit
        np.random.seed(cfg.base_seed)
        setup = ExperimentSetup(cfg, 1, verbose=False)
        res = fit(cfg, setup.spec, setup.params, setup.consts,
                  setup.train_ps, setup.valid_ps, seed=cfg.base_seed,
                  epochs_chunk=6)
        k = sum(kl)
        assert np.all(np.asarray(res.params["basis"]["centers"])[k:] == 0)
        assert np.all(
            np.asarray(res.params["basis"]["log_bandwidths"])[k:] == 0)
        w0 = np.asarray(res.params["mlp"]["linear_0"]["w"])
        assert np.all(w0[k:k_pad] == 0)
        assert not np.all(w0[:k] == 0)


class TestRaggedGridSearch:
    def test_grid_varies_k_stacks_into_one_bucket(self, toy_csv, tmp_path,
                                                  capsys):
        from st_dadk_tpu.sweep.grid import run_grid_search
        base = _cfg(toy_csv).to_dict()
        base["n_experiments"] = 2
        out = tmp_path / "grid"
        results = run_grid_search(
            base, {"k_spatial_centers": [[9], [16, 9]]}, out, engine="vmap")
        assert len(results) == 2
        captured = capsys.readouterr().out
        # both configs must run as ONE bucket (4 lanes), not two
        assert "[bucket 1/1] 2 configs" in captured
        import pandas as pd
        df = pd.read_csv(out / "grid_search_summary.csv")
        assert len(df) == 2
        assert df["test_rmse_mean"].notna().all()
