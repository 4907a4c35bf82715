"""Full data-parallel training loop: fit(mesh=...) shards minibatches over
the 'data' axis with the complete LR/EMA/early-stop machinery and must match
the single-device fit (same program, same batches; only the floating-point
reduction order differs). Runs on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet
from st_dadk_tpu.models.st_interp import init_model, spec_from_config
from st_dadk_tpu.train.loop import fit, predict

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs >=8 devices")


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
        hidden_dims=[32, 16], dropout=0.0, epochs=10, lr=1e-2,
        batch_size=64, patience=100, warmup_epochs=2, scheduler="cosine",
        grad_clip=10.0, weight_decay=1e-5, regression_type="mean",

    )
    base.update(kw)
    return ExperimentConfig.from_dict(base)


class TestDataParallelFit:
    def test_dp8_matches_single_device(self):
        """DP over 8 devices is the SAME program with sharding annotations:
        identical minibatches, identical LR tables, identical EMA/early-stop
        bookkeeping. Histories and final predictions must agree to f32
        reduction-order noise."""
        cfg = _cfg()
        train_ps = _synthetic(512, 0)
        valid_ps = _synthetic(128, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(42), spec)

        r_one = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=42,
                    epochs_chunk=10)
        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
        r_dp = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=42,
                   epochs_chunk=10, mesh=mesh)

        assert r_dp.n_epochs_run == r_one.n_epochs_run
        np.testing.assert_allclose(r_dp.history["train_loss"],
                                   r_one.history["train_loss"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r_dp.history["val_rmse"],
                                   r_one.history["val_rmse"],
                                   rtol=1e-4, atol=1e-5)
        p1 = predict(spec, r_one.params, consts, valid_ps.coords, valid_ps.t,
                     chunk=128)
        p2 = predict(spec, r_dp.params, consts, valid_ps.coords, valid_ps.t,
                     chunk=128)
        np.testing.assert_allclose(p2, p1, rtol=1e-3, atol=1e-4)

    def test_dp_full_machinery(self):
        """Learnable basis + damping + penalties + multi-quantile delta head
        all compile and stay finite under the DP sharding."""
        cfg = _cfg(regression_type="multi-quantile",
                   quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
                   use_delta_reparameterization=True, non_crossing_lambda=1.0,
                   non_crossing_delta_mode="abs",
                   spatial_learnable=True, gradient_damping=True,
                   domain_penalty_weight=0.01, epochs=6)
        train_ps = _synthetic(512, 3)
        valid_ps = _synthetic(128, 4)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(5), spec)
        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=5,
                  epochs_chunk=6, mesh=mesh)
        assert np.isfinite(res.history["train_loss"]).all()
        assert np.isfinite(res.best_val)

    def test_dp_early_stopping(self):
        cfg = _cfg(patience=3, epochs=50, lr=0.0)
        train_ps = _synthetic(256, 0)
        valid_ps = _synthetic(64, 1)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
        res = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
                  epochs_chunk=10, mesh=mesh)
        assert res.stopped_early
        assert res.n_epochs_run == 4


class TestDpStepWeightedMean:
    def test_uneven_padding_matches_unsharded_objective(self):
        """make_dp_train_step with padding concentrated in the tail shard
        (the ragged-batch layout) must compute the exact GLOBAL weighted
        mean — regression for pmean-of-local-weighted-means bias."""
        from st_dadk_tpu.parallel.data_parallel import make_dp_train_step
        from st_dadk_tpu.train.loop import LoopSpec, training_loss
        from st_dadk_tpu.train.optimizer import adamw_init

        cfg = _cfg(dropout=0.0, grad_clip=0.0)
        spec_m = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(1), spec_m)
        spec = LoopSpec.from_config(cfg, spec_m, 64, 1, 64, 1)

        n, n_real = 256, 232                    # 24 pad rows, all in tail
        rng = np.random.default_rng(5)
        coords = rng.uniform(size=(n, 2)).astype(np.float32)
        t = rng.uniform(size=(n, 1)).astype(np.float32)
        y = np.sin(3 * coords[:, :1]).astype(np.float32)
        w = np.zeros(n, np.float32)
        w[:n_real] = 1.0

        mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
        step = make_dp_train_step(spec, mesh)
        opt = adamw_init(params)
        _, _, _, loss_dp = step(params, opt, params, consts,
                                coords, t, y, w,
                                np.asarray([1e-2, 1e-2], np.float32),
                                np.asarray(0.99, np.float32),
                                jax.random.PRNGKey(0))
        want = float(training_loss(spec, params, consts,
                                   jax.numpy.asarray(coords),
                                   jax.numpy.asarray(t),
                                   jax.numpy.asarray(y),
                                   jax.numpy.asarray(w),
                                   train=True, rng=jax.random.PRNGKey(0)))
        np.testing.assert_allclose(float(loss_dp), want, rtol=1e-5)


class TestHybridExpDataMesh:
    def test_vmapped_lanes_with_inner_dp(self):
        """{'exp': 4, 'data': 2} hybrid: lanes shard over 'exp' (via
        spmd_axis_name) while each lane's minibatch shards over 'data'.
        Results must match the plain vmapped engine lane-for-lane."""
        import jax.numpy as jnp
        from dataclasses import replace as dc_replace
        from jax.sharding import NamedSharding, PartitionSpec as P
        from st_dadk_tpu.train.loop import (LoopSpec, init_carry,
                                            jitted_fit_chunk,
                                            prepare_train_data)
        from st_dadk_tpu.train.optimizer import build_lr_tables

        cfg = _cfg(epochs=4, batch_size=32)
        spec_model = spec_from_config(cfg)
        M = 4
        datas, carries, constss = [], [], []
        for i in range(M):
            data, B, vchunk = prepare_train_data(
                _synthetic(128, i), _synthetic(64, 100 + i), 32)
            params, consts = init_model(jax.random.PRNGKey(i), spec_model)
            datas.append(data)
            constss.append(consts)
            carries.append(init_carry(params, jax.random.PRNGKey(i)))
        spec = LoopSpec.from_config(cfg, spec_model, 32, B, vchunk, 1)
        stack = lambda ts: jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *ts)
        data_b, carry_b, consts_b = stack(datas), stack(carries), stack(constss)
        lr_mlp, lr_basis, _ = build_lr_tables(cfg, B)
        lr = jnp.asarray(np.stack([lr_mlp, lr_basis], -1)
                         .reshape(cfg.epochs, B, 2))
        ids = jnp.arange(cfg.epochs, dtype=jnp.int32)
        active = jnp.ones((cfg.epochs,), bool)

        # baseline: plain vmapped engine (single-device semantics per lane)
        f_plain = jitted_fit_chunk(spec, vmapped=True)
        c_plain, h_plain = f_plain(stack(carries), consts_b, data_b, ids,
                                   lr, active)

        # hybrid mesh
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                    ("exp", "data"))
        spec_dp = dc_replace(spec, dp_axis="data")
        lane = lambda t: jax.device_put(t, NamedSharding(mesh, P("exp")))
        f_hy = jitted_fit_chunk(spec_dp, vmapped=True, mesh=mesh,
                                spmd_axis="exp")
        c_hy, h_hy = f_hy(lane(stack(carries)), lane(consts_b), lane(data_b),
                          ids, lr, active)

        np.testing.assert_allclose(np.asarray(h_hy["train_loss"]),
                                   np.asarray(h_plain["train_loss"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(h_hy["val_rmse"]),
                                   np.asarray(h_plain["val_rmse"]),
                                   rtol=1e-4, atol=1e-5)
