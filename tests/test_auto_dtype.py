"""train_dtype='auto' wide-lane policy (round 4).

'auto' — the shipped default — resolves to f32 at narrow widths (identical
compiled program to the old f32 default) and flips the whole batch to the
bf16 trunk when a compiled batch runs wider than
batch_engine.AUTO_BF16_LANES lanes per device."""
from types import SimpleNamespace

import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.models.st_interp import ModelSpec, spec_from_config
from st_dadk_tpu.train import batch_engine
from st_dadk_tpu.train.batch_engine import (_apply_auto_train_dtype,
                                            _padded_lanes_per_device,
                                            run_job_batch)


def _setups(n, dtype="f32"):
    return [SimpleNamespace(spec=ModelSpec(compute_dtype=dtype))
            for _ in range(n)]


class TestResolution:
    def test_default_is_auto_and_spec_resolves_f32(self):
        cfg = ExperimentConfig()
        assert cfg.train_dtype == "auto"
        assert spec_from_config(cfg).compute_dtype == "f32"

    def test_explicit_values_pass_through(self):
        for dt in ("f32", "bf16"):
            cfg = ExperimentConfig.from_dict({"train_dtype": dt})
            assert spec_from_config(cfg).compute_dtype == dt

    def test_padded_lanes_per_device(self):
        # exact multiples
        assert _padded_lanes_per_device(16, 1, None) == 16
        assert _padded_lanes_per_device(16, 8, None) == 2
        # device padding rounds up
        assert _padded_lanes_per_device(9, 8, None) == 2
        # tail batch of a width-split stream pads to the stream width
        assert _padded_lanes_per_device(4, 1, 16) == 16
        assert _padded_lanes_per_device(4, 8, 16) == 2
        # lane_width not divisible by n_dev: no width pad applies
        assert _padded_lanes_per_device(4, 8, 12) == 1

    def test_auto_flips_only_wide_batches(self):
        cfg = ExperimentConfig()  # train_dtype='auto'
        narrow = _setups(3)
        _apply_auto_train_dtype(cfg, narrow, batch_engine.AUTO_BF16_LANES)
        assert all(s.spec.compute_dtype == "f32" for s in narrow)
        wide = _setups(3)
        _apply_auto_train_dtype(cfg, wide, batch_engine.AUTO_BF16_LANES + 1)
        assert all(s.spec.compute_dtype == "bf16" for s in wide)

    def test_explicit_f32_never_overridden(self):
        cfg = ExperimentConfig.from_dict({"train_dtype": "f32"})
        setups = _setups(2)
        _apply_auto_train_dtype(cfg, setups, 64)
        assert all(s.spec.compute_dtype == "f32" for s in setups)

    def test_auto_flips_wide_mlps_by_size(self):
        """Size trigger: 'auto' resolves bf16 once sum(hidden_dims) reaches
        st_interp.AUTO_BF16_HIDDEN_SUM, f32 below it; explicit values
        bypass the trigger."""
        from st_dadk_tpu.models.st_interp import AUTO_BF16_HIDDEN_SUM
        assert AUTO_BF16_HIDDEN_SUM == 1280  # cited crossover
        ref = ExperimentConfig.from_dict(
            {"hidden_dims": [256, 256, 128]})          # sum 640
        assert spec_from_config(ref).compute_dtype == "f32"
        mlp2x = ExperimentConfig.from_dict(
            {"hidden_dims": [512, 512, 256]})          # sum 1280
        assert spec_from_config(mlp2x).compute_dtype == "bf16"
        mlp4x = ExperimentConfig.from_dict(
            {"hidden_dims": [1024, 1024, 512]})
        assert spec_from_config(mlp4x).compute_dtype == "bf16"
        pinned = ExperimentConfig.from_dict(
            {"hidden_dims": [1024, 1024, 512], "train_dtype": "f32"})
        assert spec_from_config(pinned).compute_dtype == "f32"

    def test_explicit_bf16_kept_at_narrow_width(self):
        cfg = ExperimentConfig.from_dict({"train_dtype": "bf16"})
        setups = _setups(2, dtype="bf16")
        _apply_auto_train_dtype(cfg, setups, 1)
        assert all(s.spec.compute_dtype == "bf16" for s in setups)


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


def _cfg(tmp_path, **kw):
    base = dict(
        tag="autodtype",
        data_file=str(tmp_path / "toy.csv"),
        k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=8, lr=5e-3,
        batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
        grad_clip=10.0, regression_type="mean",
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8,
        n_experiments=2, base_seed=100,
        save_plots=False, save_artifacts=False,
    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


class TestEngineIntegration:
    def test_wide_batch_trains_bf16_and_finishes(self, toy_csv, tmp_path,
                                                 monkeypatch):
        """A batch past the (patched) threshold flips to the bf16 trunk
        in-engine and still produces finite, f32 artifacts."""
        flipped = {}
        orig = batch_engine._apply_auto_train_dtype

        def spy(cfg, setups, lanes_per_device):
            orig(cfg, setups, lanes_per_device)
            for s in setups:
                flipped.setdefault("dtypes", set()).add(
                    s.spec.compute_dtype)
        monkeypatch.setattr(batch_engine, "_apply_auto_train_dtype", spy)
        monkeypatch.setattr(batch_engine, "AUTO_BF16_LANES", 1)

        cfg = _cfg(toy_csv, n_experiments=16)
        jobs = [(cfg, e, tmp_path / "wide" / str(e)) for e in range(1, 17)]
        results = run_job_batch(jobs, epochs_chunk=8)
        assert flipped["dtypes"] == {"bf16"}
        assert len(results) == 16
        for r in results:
            assert np.isfinite(r["test_rmse"])

    def test_narrow_batch_stays_f32(self, toy_csv, tmp_path, monkeypatch):
        seen = {}
        orig = batch_engine._apply_auto_train_dtype

        def spy(cfg, setups, lanes_per_device):
            orig(cfg, setups, lanes_per_device)
            for s in setups:
                seen.setdefault("dtypes", set()).add(s.spec.compute_dtype)
        monkeypatch.setattr(batch_engine, "_apply_auto_train_dtype", spy)

        cfg = _cfg(toy_csv)
        jobs = [(cfg, e, tmp_path / "narrow" / str(e)) for e in (1, 2)]
        results = run_job_batch(jobs, epochs_chunk=8)
        assert seen["dtypes"] == {"f32"}
        assert len(results) == 2

    def test_auto_wide_matches_explicit_bf16(self, toy_csv, tmp_path,
                                             monkeypatch):
        """auto past the threshold is exactly train_dtype='bf16': same
        per-lane metrics bit-for-bit (same seeds, same compiled program)."""
        monkeypatch.setattr(batch_engine, "AUTO_BF16_LANES", 1)
        cfg_auto = _cfg(toy_csv, n_experiments=16)
        cfg_bf16 = _cfg(toy_csv, n_experiments=16, train_dtype="bf16")
        r_auto = run_job_batch(
            [(cfg_auto, e, tmp_path / "a" / str(e)) for e in range(1, 17)],
            epochs_chunk=8)
        r_bf16 = run_job_batch(
            [(cfg_bf16, e, tmp_path / "b" / str(e)) for e in range(1, 17)],
            epochs_chunk=8)
        for ra, rb in zip(r_auto, r_bf16):
            assert ra["test_rmse"] == rb["test_rmse"]
