"""End-to-end training-loop tests on tiny synthetic data."""
import jax
import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet
from st_dadk_tpu.models.st_interp import init_model, spec_from_config
from st_dadk_tpu.train.loop import adaptive_batch_size, fit, predict


def _synthetic(n=512, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + np.cos(2 * coords[:, 1:2]) + 0.5 * t
         ).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32), n_real=n)


def _cfg(**kw):
    base = dict(
        k_spatial_centers=[16], k_temporal_centers=[5],
        hidden_dims=[32, 16], dropout=0.0, epochs=30, lr=1e-2,
        batch_size=64, patience=100, warmup_epochs=2, scheduler="cosine",
        grad_clip=10.0, weight_decay=1e-5, regression_type="mean",

    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


class TestAdaptiveBatch:
    def test_halving(self):
        # ref rule: halve until >= 10 batches/epoch (:2275-2288)
        assert adaptive_batch_size(8000, 4096) == 512
        assert adaptive_batch_size(100000, 4096) == 4096
        assert adaptive_batch_size(50, 4096) == 4

    def test_floor_one(self):
        assert adaptive_batch_size(5, 2) >= 1


class TestFitMean:
    def test_loss_decreases_and_predicts(self):
        cfg = _cfg()
        train_ps = _synthetic(512, 0)
        valid_ps = _synthetic(128, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(42), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=42,
                  epochs_chunk=10)
        hist = res.history
        assert len(hist["train_loss"]) == 30
        assert hist["train_loss"][-1] < hist["train_loss"][0] * 0.8
        assert np.all(np.isfinite(hist["val_loss"]))
        assert res.n_epochs_run == 30
        # final model predicts reasonably
        preds = predict(spec, res.params, consts, valid_ps.coords,
                        valid_ps.t, chunk=256)
        rmse = np.sqrt(np.mean((preds - valid_ps.y) ** 2))
        assert rmse < 0.5
        assert len(hist["lr"]) == 30

    def test_early_stopping(self):
        cfg = _cfg(patience=3, epochs=50, lr=0.0)  # lr=0 -> no improvement
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
                  epochs_chunk=10)
        # first epoch sets best; then 3 non-improving epochs trigger stop
        assert res.stopped_early
        assert res.n_epochs_run == 4
        assert len(res.history["val_loss"]) == 4


class TestFitMultiQuantile:
    def test_delta_head_fit(self):
        cfg = _cfg(regression_type="multi-quantile",
                   quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
                   use_delta_reparameterization=True,
                   non_crossing_lambda=1.0, epochs=20)
        train_ps = _synthetic(512, 0)
        valid_ps = _synthetic(128, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(7), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=7,
                  epochs_chunk=20)
        assert np.isfinite(res.best_val)
        preds = predict(spec, res.params, consts, valid_ps.coords, valid_ps.t,
                        chunk=128)
        assert preds.shape == (128, 5)
        # median-quantile predictions should track the target
        rmse = np.sqrt(np.mean((preds[:, 2:3] - valid_ps.y) ** 2))
        assert rmse < 0.8

    def test_prediction_level_penalty_path(self):
        cfg = _cfg(regression_type="multi-quantile",
                   quantile_levels=[0.1, 0.5, 0.9],
                   use_delta_reparameterization=False,
                   non_crossing_weight=0.5, non_crossing_power=2, epochs=5)
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(1), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=1,
                  epochs_chunk=5)
        assert np.all(np.isfinite(res.history["train_loss"]))


class TestFitLearnableBasis:
    def test_learnable_with_all_mechanisms(self):
        cfg = _cfg(spatial_learnable=True, gradient_damping=True,
                   damping_threshold=0.0, damping_strength=5.0,
                   domain_penalty_weight=0.01, basis_unfreeze_epoch=2,
                   basis_lr_rampup_epochs=3, epochs=12,
                   sparsity_penalty_type="sparse_group",
                   sparsity_lambda_l1=1e-4, sparsity_lambda_group=1e-4)
        train_ps = _synthetic(512, 3)
        valid_ps = _synthetic(128, 4)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(5), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=5,
                  epochs_chunk=12)
        assert np.all(np.isfinite(res.history["train_loss"]))
        # centers moved (but only after unfreeze)
        final_centers = res.params["basis"]["centers"]
        init_centers = np.asarray(consts["spatial_centers_init"])
        assert not np.allclose(final_centers, init_centers)

    def test_frozen_before_unfreeze(self):
        # NOTE scheduler=None: with a cosine scheduler the reference's
        # epoch-end scheduler step assigns a NONZERO basis LR even before
        # unfreeze (recursion from 0 toward eta_min) — a faithful quirk
        # covered by test_optimizer.TestLrTables.
        cfg = _cfg(spatial_learnable=True, basis_unfreeze_epoch=100,
                   epochs=5, warmup_epochs=0, scheduler=None)
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(9), spec)
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=9,
                  epochs_chunk=5)
        # basis LR stays 0 until epoch 100 (never reached): identical centers.
        # NOTE: AdamW weight decay multiplies by (1 - lr*wd) = 1 when lr=0.
        assert np.allclose(res.params["basis"]["centers"],
                           np.asarray(consts["spatial_centers_init"]), atol=1e-7)


class TestPackedOptimizerPath:
    def test_packed_matches_unpacked_with_damping(self):
        """The flat-packed epoch program (packed_optimizer=True, a documented
        negative-result flag) must stay numerically equivalent to the
        default unpacked path — including gradient damping, which the packed
        path routes through the same optimizer helper."""
        kw = dict(epochs=6, spatial_learnable=True, gradient_damping=True,
                  damping_threshold=0.0, damping_strength=5.0,
                  domain_penalty_weight=0.01, basis_lr_ratio=0.05,
                  basis_unfreeze_epoch=0, grad_clip=10.0)
        train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
        cfg_a = _cfg(**kw)
        cfg_b = _cfg(packed_optimizer=True, **kw)
        spec = spec_from_config(cfg_a)
        params, consts = init_model(jax.random.PRNGKey(7), spec)
        r_a = fit(cfg_a, spec, params, consts, train_ps, valid_ps, seed=7,
                  epochs_chunk=6)
        r_b = fit(cfg_b, spec, params, consts, train_ps, valid_ps, seed=7,
                  epochs_chunk=6)
        np.testing.assert_allclose(r_b.history["train_loss"],
                                   r_a.history["train_loss"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r_b.history["val_rmse"],
                                   r_a.history["val_rmse"],
                                   rtol=1e-4, atol=1e-6)


class TestRematPath:
    def test_remat_matches_default(self):
        """remat=true (jax.checkpoint around the training forward) must be a
        pure scheduling change: the recomputed forward runs the identical
        ops, so losses/metrics match the default path to float tolerance.
        Exercises dropout + learnable basis so the rematerialized closure
        carries rng and basis params through the checkpoint."""
        kw = dict(epochs=6, dropout=0.1, spatial_learnable=True,
                  gradient_damping=True, damping_threshold=0.0,
                  damping_strength=5.0, basis_unfreeze_epoch=0)
        train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
        cfg_a = _cfg(**kw)
        cfg_b = _cfg(remat=True, **kw)
        spec = spec_from_config(cfg_a)
        params, consts = init_model(jax.random.PRNGKey(7), spec)
        r_a = fit(cfg_a, spec, params, consts, train_ps, valid_ps, seed=7,
                  epochs_chunk=6)
        r_b = fit(cfg_b, spec, params, consts, train_ps, valid_ps, seed=7,
                  epochs_chunk=6)
        np.testing.assert_allclose(r_b.history["train_loss"],
                                   r_a.history["train_loss"],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r_b.history["val_rmse"],
                                   r_a.history["val_rmse"],
                                   rtol=1e-4, atol=1e-6)


class TestWeightedPaddingInvariance:
    def test_padding_does_not_change_eval(self):
        """Validation metrics must be identical whether or not the valid set
        carries weight-0 padding rows — asserted by padding the SAME valid
        points to two different capacities (100 -> cap 100 vs cap 256)."""
        from st_dadk_tpu.train.loop import (LoopSpec, _validate,
                                            prepare_train_data)
        cfg = _cfg(epochs=3)
        train_ps = _synthetic(256, 0)
        valid_a = _synthetic(100, 1)
        spec_model = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(2), spec_model)

        data1, B, vc1 = prepare_train_data(train_ps, valid_a, 64)
        assert data1.va_coords.shape[0] == 100       # no padding
        data2, _, vc2 = prepare_train_data(train_ps, valid_a, 64,
                                           val_chunk=256, cap_va=256)
        assert data2.va_coords.shape[0] == 256       # 156 padding rows
        assert vc1 != vc2

        import jax.numpy as jnp
        to_dev = lambda d: jax.tree_util.tree_map(jnp.asarray, d)
        spec1 = LoopSpec.from_config(cfg, spec_model, 64, B, vc1, 1)
        spec2 = LoopSpec.from_config(cfg, spec_model, 64, B, vc2, 1)
        l1, r1 = _validate(spec1, params, consts, to_dev(data1))
        l2, r2 = _validate(spec2, params, consts, to_dev(data2))
        assert np.isclose(float(l1), float(l2), atol=1e-6), (l1, l2)
        assert np.isclose(float(r1), float(r2), atol=1e-6), (r1, r2)


class TestDeltaPenaltyModes:
    def test_abs_mode_keeps_loss_bounded(self):
        """'eq310' (reference-exact) rewards ever more negative P_nc(delta)
        and runs away; 'abs' penalizes infeasibility and stays bounded."""
        train_ps = _synthetic(512, 0)
        valid_ps = _synthetic(128, 1)
        results = {}
        for mode in ("eq310", "abs"):
            cfg = _cfg(regression_type="multi-quantile",
                       quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
                       use_delta_reparameterization=True,
                       non_crossing_lambda=1.0,
                       non_crossing_delta_mode=mode, epochs=25, lr=2e-2)
            spec = spec_from_config(cfg)
            params, consts = init_model(jax.random.PRNGKey(0), spec)
            res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
                      epochs_chunk=25)
            results[mode] = res.history["train_loss"]
        # eq310: monotone dive into large negative territory
        assert results["eq310"][-1] < -1.0
        # abs: stays near the data term
        assert results["abs"][-1] > -0.1
        assert np.isfinite(results["abs"]).all()


class TestDropoutRng:
    """The dropout mask stream is configurable: 'rbg' (lax.rng_bit_generator,
    the default) vs 'threefry' (jax default). Both must be deterministic per
    seed; the two streams differ; dropout=0 is stream-independent."""

    def _fit(self, **kw):
        cfg = _cfg(dropout=0.1, epochs=8, **kw)
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(7), spec)
        return fit(cfg, spec, params, consts, train_ps, valid_ps, seed=7,
                   epochs_chunk=8)

    def test_rbg_deterministic(self):
        a = self._fit(dropout_rng="rbg")
        b = self._fit(dropout_rng="rbg")
        np.testing.assert_array_equal(a.history["train_loss"],
                                      b.history["train_loss"])
        assert np.all(np.isfinite(a.history["train_loss"]))

    def test_streams_differ_but_both_train(self):
        a = self._fit(dropout_rng="rbg")
        b = self._fit(dropout_rng="threefry")
        assert not np.array_equal(a.history["train_loss"],
                                  b.history["train_loss"])
        for r in (a, b):
            hist = r.history
            assert hist["train_loss"][-1] < hist["train_loss"][0]

    def test_no_dropout_ignores_impl(self):
        cfg_kw = dict(dropout=0.0, epochs=5)
        cfg_a = _cfg(dropout_rng="rbg", **cfg_kw)
        cfg_b = _cfg(dropout_rng="threefry", **cfg_kw)
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        outs = []
        for cfg in (cfg_a, cfg_b):
            spec = spec_from_config(cfg)
            params, consts = init_model(jax.random.PRNGKey(7), spec)
            outs.append(fit(cfg, spec, params, consts, train_ps, valid_ps,
                            seed=7, epochs_chunk=5))
        np.testing.assert_array_equal(outs[0].history["train_loss"],
                                      outs[1].history["train_loss"])


class TestHashShuffle:
    """shuffle='hash'/'auto': sort-free keyed bijection (loop.hash_permutation)."""

    def test_bijection_across_caps_and_seeds(self):
        from st_dadk_tpu.train.loop import hash_permutation
        for cap in (2, 16, 4096, 8192, 131072):
            for seed in (0, 1, 2025):
                p = np.asarray(hash_permutation(jax.random.PRNGKey(seed), cap))
                assert np.array_equal(np.sort(p), np.arange(cap)), (cap, seed)

    def test_orders_differ_across_epoch_keys(self):
        from st_dadk_tpu.train.loop import hash_permutation
        a = np.asarray(hash_permutation(jax.random.PRNGKey(0), 8192))
        b = np.asarray(hash_permutation(jax.random.PRNGKey(1), 8192))
        assert not np.array_equal(a, b)
        # overlap of the first half across keys ~ uniform expectation (0.5)
        ov = len(set(a[:4096].tolist()) & set(b[:4096].tolist())) / 4096
        assert 0.35 < ov < 0.65

    def test_auto_routes_uniform_to_hash(self):
        import jax.numpy as jnp
        from st_dadk_tpu.train.loop import (epoch_batch_indices,
                                            hash_permutation)
        key, cap, bs, B = jax.random.PRNGKey(3), 8192, 4096, 2
        idx = np.asarray(epoch_batch_indices(key, cap, bs, B,
                                             jnp.asarray(B), uniform=True,
                                             shuffle="auto"))
        expect = np.asarray(hash_permutation(key, cap)).reshape(B, bs)
        assert np.array_equal(idx, expect)
        # non-pow2 cap: compacted hash — still an exact cover of [0, cap)
        cap2, bs2, B2 = 96, 32, 3
        idx2 = np.asarray(epoch_batch_indices(jax.random.PRNGKey(4), cap2,
                                              bs2, B2, jnp.asarray(B2),
                                              uniform=True, shuffle="auto"))
        assert set(idx2.ravel().tolist()) == set(range(cap2))

    def test_hash_permutation_any_non_pow2(self):
        from st_dadk_tpu.train.loop import hash_permutation_any
        for cap in (3, 96, 1000, 8000, 48000):
            p = np.asarray(hash_permutation_any(jax.random.PRNGKey(cap), cap))
            assert np.array_equal(np.sort(p), np.arange(cap)), cap
        # orders differ across keys and are not near-identity
        a = np.asarray(hash_permutation_any(jax.random.PRNGKey(0), 8000))
        b = np.asarray(hash_permutation_any(jax.random.PRNGKey(1), 8000))
        assert not np.array_equal(a, b)
        assert np.mean(a == np.arange(8000)) < 0.01

    def test_nonuniform_lanes_keep_partition_semantics(self):
        """auto with non-uniform lanes uses the partitioned sort path: a
        lane with fewer real batches still sees all its own capacity."""
        import jax.numpy as jnp
        from st_dadk_tpu.train.loop import epoch_batch_indices
        bs, B, B_lane = 32, 5, 3
        cap = B * bs
        idx = np.asarray(epoch_batch_indices(jax.random.PRNGKey(5), cap, bs,
                                             B, jnp.asarray(B_lane),
                                             uniform=False, shuffle="auto"))
        assert set(idx[:B_lane].ravel().tolist()) == set(range(B_lane * bs))


class TestTrainDtypeBf16:
    """train_dtype='bf16' (mixed-precision trunk, config.py train_dtype):
    activations/cotangents flow in bfloat16 while params, LayerNorm stats,
    the loss, and the optimizer stay f32 — the fit must track the f32 run."""

    def test_bf16_fit_tracks_f32(self):
        train_ps = _synthetic(512, 0)
        valid_ps = _synthetic(128, 1)
        rmse = {}
        for dt in ("f32", "bf16"):
            cfg = _cfg(train_dtype=dt)
            spec = spec_from_config(cfg)
            assert spec.compute_dtype == dt
            params, consts = init_model(jax.random.PRNGKey(42), spec)
            res = fit(cfg, spec, params, consts, train_ps, valid_ps,
                      seed=42, epochs_chunk=10)
            hist = res.history
            assert np.all(np.isfinite(hist["train_loss"])), dt
            assert hist["train_loss"][-1] < hist["train_loss"][0] * 0.8, dt
            # params and the returned best model stay f32
            for leaf in jax.tree_util.tree_leaves(res.params):
                assert leaf.dtype == np.float32, dt
            preds = predict(spec, res.params, consts, valid_ps.coords,
                            valid_ps.t, chunk=256)
            assert preds.dtype == np.float32, dt
            rmse[dt] = float(np.sqrt(np.mean((preds - valid_ps.y) ** 2)))
        # bf16 rounding perturbs the trajectory but not the end metric
        assert rmse["bf16"] < 0.5
        assert abs(rmse["bf16"] - rmse["f32"]) < 0.15

    def test_bf16_forward_head_returns_f32(self):
        from st_dadk_tpu.models.st_interp import forward
        cfg = _cfg(train_dtype="bf16", regression_type="multi-quantile",
                   quantile_levels=[0.25, 0.5, 0.75],
                   use_delta_reparameterization=True)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        ps = _synthetic(64, 2)
        out = forward(spec, params, consts, None, ps.coords, ps.t,
                      train=False)
        assert out.dtype == np.float32
        assert out.shape == (64, 3)
        # train-mode with dropout also stays f32 at the head
        cfg2 = _cfg(train_dtype="bf16", dropout=0.3)
        spec2 = spec_from_config(cfg2)
        p2, c2 = init_model(jax.random.PRNGKey(0), spec2)
        out2 = forward(spec2, p2, c2, None, ps.coords, ps.t, train=True,
                       rng=jax.random.PRNGKey(7))
        assert out2.dtype == np.float32
        assert np.all(np.isfinite(np.asarray(out2)))
