"""Batch-engine integration tests on the virtual 8-device CPU mesh: vmapped
lanes sharded over 'exp' must produce per-lane results equivalent to
sequential single fits, and the results contract must appear on disk."""
import json
from pathlib import Path

import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.train.batch_engine import run_experiment_batch
from st_dadk_tpu.train.experiment import run_single_experiment
from st_dadk_tpu.train.runner import run_multiple_experiments


def _cfg(tmp_path, **kw):
    base = dict(
        tag="batchtest",
        data_file=str(tmp_path / "toy.csv"),
        k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=8, lr=5e-3,
        batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
        grad_clip=10.0, regression_type="mean",
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8,
        n_experiments=4, base_seed=100,
        save_plots=False, save_artifacts=True,
    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return tmp_path


class TestBatchEngine:
    def test_runs_and_writes_contract(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv)
        exp_dir = tmp_path / "experiments"
        results = run_experiment_batch(cfg, [1, 2, 3, 4], exp_dir,
                                       epochs_chunk=8)
        assert len(results) == 4
        for i in (1, 2, 3, 4):
            d = exp_dir / str(i)
            assert (d / "results.json").exists()
            assert (d / "training_history.csv").exists()
            assert (d / "predictions.npz").exists()
            assert (d / "basis_info.npz").exists()
            with open(d / "results.json") as f:
                r = json.load(f)
            assert np.isfinite(r["test_rmse"])
            assert len(r["training_history"]["train_loss"]) == 8
            assert r["experiment_seed"] == 100 + i - 1

    def test_lanes_differ_by_seed(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv)
        results = run_experiment_batch(cfg, [1, 2], tmp_path / "e",
                                       epochs_chunk=8)
        # different seeds -> different masks/inits -> different metrics
        assert results[0]["test_rmse"] != results[1]["test_rmse"]

    def test_matches_sequential_engine_closely(self, toy_csv, tmp_path):
        """vmapped lane vs a standalone fit with the same seed: identical
        masks and init; training differs only in masked-step arithmetic, so
        final metrics agree closely."""
        cfg = _cfg(toy_csv, n_experiments=1)
        r_seq = run_single_experiment(cfg, 1, tmp_path / "seq", verbose=False)
        r_bat = run_experiment_batch(cfg, [1], tmp_path / "bat",
                                     epochs_chunk=8)[0]
        assert np.isclose(r_seq["test_rmse"], r_bat["test_rmse"], rtol=0.05)
        assert r_seq["experiment_seed"] == r_bat["experiment_seed"]

    def test_runner_vmap_engine_and_aggregation(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv)
        out = tmp_path / "run"
        summary = run_multiple_experiments(cfg, out, engine="vmap")
        assert summary["n_experiments"] == 4
        assert (out / "summary" / "summary_statistics.json").exists()
        assert (out / "summary" / "all_experiments.csv").exists()
        stats = summary["statistics"]["test_rmse"]
        assert len(stats["values"]) == 4
        assert stats["min"] <= stats["mean"] <= stats["max"]

    def test_eval_fallback_repulls_params(self, toy_csv, tmp_path,
                                          monkeypatch, capsys):
        """If the batched device eval fails, the per-lane fallback must
        still produce real metrics even when the params pull was skipped
        (metric-only runs pull no params up front — regression for the
        fallback evaluating with empty params)."""
        import st_dadk_tpu.train.batch_engine as be

        def boom(*a, **kw):
            raise RuntimeError("synthetic eval failure")

        monkeypatch.setattr(be, "_batched_eval_device", boom)
        cfg = _cfg(toy_csv, save_artifacts=False)   # metric-only: no pull
        results = run_experiment_batch(cfg, [1, 2], tmp_path / "fb",
                                       epochs_chunk=8)
        assert "falling back per-lane" in capsys.readouterr().out
        assert len(results) == 2
        for r in results:
            assert np.isfinite(r["test_rmse"])

    def test_skip_existing(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv, n_experiments=2)
        out = tmp_path / "sk"
        run_experiment_batch(cfg, [1, 2], out, epochs_chunk=8)
        t0 = (out / "1" / "results.json").stat().st_mtime
        res = run_experiment_batch(cfg, [1, 2], out, skip_existing=True,
                                   epochs_chunk=8)
        assert res == []
        assert (out / "1" / "results.json").stat().st_mtime == t0


class TestUnequalLaneCapacity:
    def test_epoch_indices_cover_lane_capacity(self):
        """A lane with B_lane < B must see ALL of its own capacity in its
        executed batches each epoch (regression: real points permuted into
        surplus batches were silently skipped)."""
        import jax
        from st_dadk_tpu.train.loop import epoch_batch_indices
        bs, B, B_lane = 32, 5, 3
        cap = B * bs
        for seed in range(4):
            idx = np.asarray(epoch_batch_indices(
                jax.random.PRNGKey(seed), cap, bs, B,
                np.asarray(B_lane, np.int32)))
            executed = idx[:B_lane].ravel()
            assert set(executed.tolist()) == set(range(B_lane * bs))
        # full-capacity lane: plain permutation of everything
        idx = np.asarray(epoch_batch_indices(
            jax.random.PRNGKey(0), cap, bs, B, np.asarray(B, np.int32)))
        assert set(idx.ravel().tolist()) == set(range(cap))

    def test_stacked_lanes_with_different_batch_counts(self, toy_csv, tmp_path):
        """Config-level stacking with different obs_ratio -> different real
        batch counts per lane; per-lane LR tables + partitioned permutations
        keep every lane training on all of its data."""
        from st_dadk_tpu.train.batch_engine import run_job_batch
        cfg_lo = _cfg(toy_csv, obs_ratio=0.3)
        cfg_hi = _cfg(toy_csv, obs_ratio=0.9)
        jobs = [(cfg_lo, 1, tmp_path / "lo"), (cfg_hi, 1, tmp_path / "hi")]
        results = run_job_batch(jobs, epochs_chunk=8)
        assert len(results) == 2
        for r in results:
            assert np.isfinite(r["test_rmse"])
            assert np.isfinite(r["training_history"]["train_loss"]).all()


class TestMultiQuantileBatch:
    def test_delta_head_lanes(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv, regression_type="multi-quantile",
                   quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
                   use_delta_reparameterization=True, non_crossing_lambda=1.0,
                   spatial_learnable=True, spatial_init_method="gmm",
                   gradient_damping=True, n_experiments=2)
        results = run_experiment_batch(cfg, [1, 2], tmp_path / "mq",
                                       epochs_chunk=8)
        for r in results:
            assert "test_crps" in r and np.isfinite(r["test_crps"])
            assert r["quantile_levels"] == [0.05, 0.25, 0.5, 0.75, 0.95]


class TestTailCompaction:
    """Tail compaction (gather still-active lanes into a narrower program
    after compaction_epoch) must not change ANY result: lanes are
    independent and stopped carries are frozen."""

    def test_compacted_equals_full_width(self, toy_csv, tmp_path, capsys):
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from st_dadk_tpu.train.batch_engine import run_job_batch

        # 1-device mesh so M_pad=6 lanes can narrow; small patience so some
        # lanes stop before the compaction point and others after
        mesh = Mesh(np.array(jax.devices()[:1]), ("exp",))

        def run(compact, out):
            # with these seeds and the 'perm' shuffle (pinned — the recorded
            # stop epochs are order-dependent) the 8 lanes stop at
            # [55, 56, 62, 47, 36, 72, 61, 51]; compacting at 60 leaves 3
            # active -> a narrower tail program
            cfg = _cfg(toy_csv, epochs=120, patience=1, n_experiments=8,
                       extra={"shuffle": "perm"},
                       tail_compaction=compact, compaction_epoch=60,
                       save_artifacts=False)
            jobs = [(cfg, i, tmp_path / out / str(i)) for i in range(1, 9)]
            return run_job_batch(jobs, epochs_chunk=120, mesh=mesh,
                                 verbose=True)

        r_full = run(False, "full")
        r_comp = run(True, "comp")
        assert "tail compaction" in capsys.readouterr().out

        for a, b in zip(r_full, r_comp):
            assert a["experiment_seed"] == b["experiment_seed"]
            np.testing.assert_allclose(a["test_rmse"], b["test_rmse"],
                                       rtol=1e-6)
            np.testing.assert_allclose(a["valid_rmse"], b["valid_rmse"],
                                       rtol=1e-6)
            ha = a["training_history"]["train_loss"]
            hb = b["training_history"]["train_loss"]
            assert len(ha) == len(hb)
            np.testing.assert_allclose(ha, hb, rtol=1e-5)

    def test_compaction_with_center_trajectories(self, toy_csv, tmp_path):
        """compaction_epoch that is not a multiple of 100 must still work
        when center trajectories are recorded (chunk lengths round to
        centers_every); results equal the uncompacted run."""
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from st_dadk_tpu.train.batch_engine import run_job_batch

        mesh = Mesh(np.array(jax.devices()[:1]), ("exp",))

        def run(compact, out):
            cfg = _cfg(toy_csv, epochs=200, patience=1, n_experiments=4,
                       spatial_learnable=True, spatial_init_method="uniform",
                       tail_compaction=compact, compaction_epoch=120,
                       save_artifacts=False)
            jobs = [(cfg, i, tmp_path / out / str(i)) for i in range(1, 5)]
            return run_job_batch(jobs, epochs_chunk=200, mesh=mesh)

        r_full = run(False, "cf")
        r_comp = run(True, "cc")
        for a, b in zip(r_full, r_comp):
            np.testing.assert_allclose(a["test_rmse"], b["test_rmse"],
                                       rtol=1e-6)


class TestPerTauVmapEngine:
    """Separate-models-per-tau quantile mode on the vmap engine: per-tau
    fits become lanes (tau is runtime lane data), artifacts and the
    aggregated CRPS must match the sequential path."""

    def test_matches_sequential_per_tau(self, toy_csv, tmp_path):
        import numpy as np

        cfg = _cfg(toy_csv, regression_type="quantile",
                   quantile_levels=[0.25, 0.5, 0.75], n_experiments=1,
                   epochs=10, save_plots=False)
        r_seq = run_single_experiment(cfg, 1, tmp_path / "seq",
                                      verbose=False)
        r_bat = run_experiment_batch(cfg, [1], tmp_path / "bat",
                                     epochs_chunk=10)[0]
        assert r_bat["regression_type"] == "quantile"
        assert r_bat["quantile_levels"] == [0.25, 0.5, 0.75]
        for d in (tmp_path / "bat" / "1", ):
            assert (d / "results.json").exists()
            for q in (0.25, 0.5, 0.75):
                assert (d / f"quantile_{q}" / "results.json").exists()
                assert (d / f"quantile_{q}" / "predictions.npz").exists()
        # same seeds -> same masks/inits; lane arithmetic matches the
        # standalone fits closely
        np.testing.assert_allclose(r_bat["test_crps"], r_seq["test_crps"],
                                   rtol=0.05)
        np.testing.assert_allclose(r_bat["test_check_loss"],
                                   r_seq["test_check_loss"], rtol=0.05)

    def test_mixed_tau_lanes_differ(self, toy_csv, tmp_path):
        """Different tau lanes of one stacked batch must actually train
        DIFFERENT objectives (tau reaches the loss as lane data)."""
        import json

        cfg = _cfg(toy_csv, regression_type="quantile",
                   quantile_levels=[0.1, 0.9], n_experiments=1,
                   epochs=10, save_plots=False)
        run_experiment_batch(cfg, [1], tmp_path / "m", epochs_chunk=10)
        with open(tmp_path / "m" / "1" / "quantile_0.1" /
                  "results.json") as f:
            lo = json.load(f)
        with open(tmp_path / "m" / "1" / "quantile_0.9" /
                  "results.json") as f:
            hi = json.load(f)
        # tau=0.1 predictions sit well below tau=0.9 -> different metrics
        assert lo["test_check_loss"] != hi["test_check_loss"]
        assert abs(lo["test_mae"] - hi["test_mae"]) > 1e-4

    def test_single_level_quantile_default_tau(self, toy_csv, tmp_path):
        """Regression: quantile with ONE level and current_quantile unset
        must train at quantile_levels[0] (sequential-path normalization),
        not crash or silently use 0.5."""
        import json

        cfg = _cfg(toy_csv, regression_type="quantile",
                   quantile_levels=[0.9], n_experiments=2, epochs=8,
                   save_plots=False)
        res = run_experiment_batch(cfg, [1, 2], tmp_path / "q1",
                                   epochs_chunk=8)
        assert len(res) == 2
        with open(tmp_path / "q1" / "1" / "results.json") as f:
            r = json.load(f)
        assert r["quantile_level"] == 0.9


class TestLaneWidthSplit:
    """run_lane_jobs: wide workloads stream as sweet-spot batches whose tail
    pads to the common width (one compiled program for the whole stream)."""

    def test_split_stream_matches_single_batch(self, toy_csv, tmp_path):
        from st_dadk_tpu.train.batch_engine import run_job_batch, run_lane_jobs
        cfg = _cfg(toy_csv, n_experiments=12,
                   extra={"lanes_per_device": 1})   # width = 8 on the 8-mesh
        jobs_a = [(cfg, i, tmp_path / "wide" / str(i)) for i in range(1, 13)]
        jobs_b = [(cfg, i, tmp_path / "split" / str(i)) for i in range(1, 13)]
        wide = run_job_batch(jobs_a, epochs_chunk=8)
        split = run_lane_jobs(jobs_b, cfg, epochs_chunk=8)
        assert len(wide) == len(split) == 12
        for a, b in zip(wide, split):
            assert a["experiment_seed"] == b["experiment_seed"]
            np.testing.assert_allclose(a["test_rmse"], b["test_rmse"],
                                       rtol=1e-5)
        # tail batch (4 lanes) really ran padded to width 8: results on disk
        for i in range(1, 13):
            assert (tmp_path / "split" / str(i) / "results.json").exists()

    def test_narrow_list_stays_one_batch(self, toy_csv, tmp_path):
        from st_dadk_tpu.train.batch_engine import run_lane_jobs
        cfg = _cfg(toy_csv, n_experiments=3)
        jobs = [(cfg, i, tmp_path / "n" / str(i)) for i in range(1, 4)]
        out = run_lane_jobs(jobs, cfg, epochs_chunk=8)
        assert len(out) == 3


class TestEvalGroupKey:
    """Eval lanes may share one vmapped inference only when they share the
    RESOLVED dataset and target scaling (regression: keying on the raw
    data_file string grouped lanes whose data_root or normalize_target
    differed, silently evaluating them on the wrong field/scale)."""

    def test_normalize_target_splits_groups(self, toy_csv):
        from st_dadk_tpu.train.batch_engine import _eval_group_key
        a = _cfg(toy_csv, normalize_target=False)
        b = _cfg(toy_csv, normalize_target=True)
        assert _eval_group_key(a) != _eval_group_key(b)

    def test_data_root_resolution_in_key(self, toy_csv, tmp_path):
        from st_dadk_tpu.train.batch_engine import _eval_group_key
        other = tmp_path / "other"
        other.mkdir()
        (other / "toy.csv").write_text((toy_csv / "toy.csv").read_text())
        a = _cfg(toy_csv, data_file="toy.csv", data_root=str(toy_csv))
        b = _cfg(toy_csv, data_file="toy.csv", data_root=str(other))
        assert _eval_group_key(a) != _eval_group_key(b)
        # identical resolution -> identical key (lanes DO stack)
        a2 = _cfg(toy_csv, data_file="toy.csv", data_root=str(toy_csv))
        assert _eval_group_key(a) == _eval_group_key(a2)
