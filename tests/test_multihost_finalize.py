"""Process-gated finalize for multi-host runs (round-2 roadmap item).

On a pod every process runs the same SPMD program but must pull/evaluate/
write artifacts ONLY for its own lanes (non-owned lane rows of a global
jax.Array are not even addressable locally), and cross-lane aggregation must
run once on the primary process. A real pod is unavailable here, so:

  - `fetch_lane_rows` is exercised on real sharded arrays (single-process,
    fully addressable) and on duck-typed fakes that mimic a multi-process
    array (is_fully_addressable=False + addressable_shards);
  - the gated finalize path is exercised by monkeypatching
    `batch_engine._owned_lane_slice` to a half-batch slice and checking the
    artifact partition and per-lane value equality with the ungated run;
  - primary gating in the runner is exercised by faking is_primary()=False.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.parallel.multihost import fetch_lane_rows, fetch_lane_tree
from st_dadk_tpu.train import batch_engine
from st_dadk_tpu.train.loop import pull_serving_state, pull_tree


def _cfg(tmp_path, **kw):
    base = dict(
        tag="mhfin",
        data_file=str(tmp_path / "toy.csv"),
        k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=6, lr=5e-3,
        batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
        grad_clip=10.0, regression_type="mean",
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8,
        n_experiments=4, base_seed=300,
        save_plots=False, save_artifacts=True,
    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(30, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 11):
        for s in range(30):
            z = np.cos(2 * coords[s, 1]) + 0.05 * t + rng.normal(0, 0.05)
            lines.append(f"{coords[s,0]},{coords[s,1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return tmp_path


class FakeShard:
    def __init__(self, index, data):
        self.index = index
        self.data = data


class FakeGlobalArray:
    """Mimics a multi-process jax.Array: only some lane rows addressable."""
    is_fully_addressable = False

    def __init__(self, full, row_ranges):
        self.shape = full.shape
        self.addressable_shards = [
            FakeShard((slice(lo, hi),) + (slice(None),) * (full.ndim - 1),
                      full[lo:hi])
            for lo, hi in row_ranges]


class TestFetchLaneRows:
    def test_fully_addressable_equals_slice(self):
        x = np.arange(48, dtype=np.float32).reshape(8, 6)
        mesh = Mesh(np.array(jax.devices()), ("exp",))
        xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("exp")))
        got = fetch_lane_rows(xd, slice(2, 5))
        np.testing.assert_array_equal(got, x[2:5])

    def test_fake_multiprocess_stitches_owned_rows(self):
        full = np.arange(64, dtype=np.float32).reshape(8, 8)
        # this "process" owns rows 4..8, split across two device shards
        arr = FakeGlobalArray(full, [(4, 6), (6, 8)])
        got = fetch_lane_rows(arr, slice(4, 8))
        np.testing.assert_array_equal(got, full[4:8])
        # a sub-block of the owned rows also works
        np.testing.assert_array_equal(fetch_lane_rows(arr, slice(5, 7)),
                                      full[5:7])

    def test_fake_multiprocess_missing_rows_raise(self):
        full = np.zeros((8, 3), np.float32)
        arr = FakeGlobalArray(full, [(4, 8)])
        with pytest.raises(ValueError, match="not addressable"):
            fetch_lane_rows(arr, slice(0, 4))
        with pytest.raises(ValueError, match="not addressable"):
            fetch_lane_rows(arr, slice(3, 6))   # partially owned

    def test_tree_variant(self):
        tree = {"a": jnp.arange(12.0).reshape(4, 3),
                "b": jnp.arange(4.0)}
        out = fetch_lane_tree(tree, slice(1, 3))
        np.testing.assert_array_equal(out["a"],
                                      np.arange(12.0).reshape(4, 3)[1:3])
        np.testing.assert_array_equal(out["b"], [1.0, 2.0])


class TestLaneSlicedPulls:
    def test_pull_tree_lane_slice(self):
        tree = {"w": jnp.arange(24.0).reshape(4, 3, 2),
                "b": jnp.arange(8.0).reshape(4, 2)}
        full = pull_tree(tree)
        part = pull_tree(tree, slice(1, 3))
        for k in tree:
            np.testing.assert_array_equal(part[k], np.asarray(full[k])[1:3])

    def test_pull_serving_state_lane_slice(self):
        M = 4
        p = {"w": jnp.arange(float(M * 3)).reshape(M, 3)}
        carry = {
            "params": p, "ema": p,
            "best_ema": jax.tree_util.tree_map(lambda x: x + 100.0, p),
            "has_best": jnp.array([True, False, True, False]),
            "best_val": jnp.arange(float(M)),
            "stopped": jnp.array([False, True, False, True]),
            "stop_epoch": jnp.arange(M, dtype=jnp.int32),
        }
        serve_full, scal_full = pull_serving_state(carry)
        serve_sl, scal_sl = pull_serving_state(carry, lanes=slice(1, 3))
        np.testing.assert_array_equal(serve_sl["w"], serve_full["w"][1:3])
        for k in scal_full:
            np.testing.assert_array_equal(scal_sl[k], scal_full[k][1:3])


class TestGatedFinalize:
    def test_owned_slice_single_process_is_all(self, toy_csv, tmp_path):
        cfg = _cfg(toy_csv)
        state = {"M": 4, "M_pad": 8, "cfg": cfg,
                 "mesh": Mesh(np.array(jax.devices()), ("exp",))}
        assert batch_engine._owned_lane_slice(state) == slice(0, 4)

    def test_half_batch_gating_partitions_artifacts(self, toy_csv, tmp_path,
                                                    monkeypatch):
        cfg = _cfg(toy_csv)
        exp_dir = tmp_path / "experiments"
        jobs = [(cfg, i, exp_dir / str(i)) for i in (1, 2, 3, 4)]
        state = batch_engine._train_job_batch(jobs, epochs_chunk=6)

        # "process 1" of a fake 2-process pod owns lanes 0..2
        monkeypatch.setattr(batch_engine, "_owned_lane_slice",
                            lambda s: slice(0, 2))
        res_lo = batch_engine._finalize_job_batch(state)
        assert [r["experiment_id"] for r in res_lo] == [1, 2]
        assert (exp_dir / "1" / "results.json").exists()
        assert not (exp_dir / "3" / "results.json").exists()

        # "process 2" owns lanes 2..4; finalize is read-only on device state
        monkeypatch.setattr(batch_engine, "_owned_lane_slice",
                            lambda s: slice(2, 4))
        res_hi = batch_engine._finalize_job_batch(state)
        assert [r["experiment_id"] for r in res_hi] == [3, 4]
        assert (exp_dir / "3" / "results.json").exists()

        # the gated halves must equal the ungated full finalize lane-by-lane
        monkeypatch.undo()
        res_full = batch_engine._finalize_job_batch(state)
        assert [r["experiment_id"] for r in res_full] == [1, 2, 3, 4]
        for gated, full in zip(res_lo + res_hi, res_full):
            assert gated["test_rmse"] == pytest.approx(full["test_rmse"],
                                                       rel=1e-6)
            assert gated["valid_rmse"] == pytest.approx(full["valid_rmse"],
                                                        rel=1e-6)


class TestPrimaryAggregation:
    def test_non_primary_skips_summary(self, toy_csv, tmp_path, monkeypatch):
        import st_dadk_tpu.parallel.multihost as mh
        from st_dadk_tpu.train.runner import run_multiple_experiments

        monkeypatch.setattr(mh, "is_primary", lambda: False)
        cfg = _cfg(toy_csv, n_experiments=2)
        out = tmp_path / "run"
        summary = run_multiple_experiments(cfg, out, engine="vmap")
        assert summary is None
        assert not (out / "summary" / "summary_statistics.json").exists()
        # lanes themselves were still written (this process owns them all)
        assert (out / "experiments" / "1" / "results.json").exists()

    def test_primary_aggregates(self, toy_csv, tmp_path):
        from st_dadk_tpu.train.runner import run_multiple_experiments

        cfg = _cfg(toy_csv, n_experiments=2)
        out = tmp_path / "run2"
        summary = run_multiple_experiments(cfg, out, engine="vmap")
        assert summary is not None
        assert (out / "summary" / "summary_statistics.json").exists()
