"""Tensor-parallel basis sharding: exact agreement with the unsharded
forward on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu.models.st_interp import ModelSpec, forward, init_model
from st_dadk_tpu.parallel.mesh import make_mesh
from st_dadk_tpu.parallel.tensor_parallel import (make_tp_forward, place_tp,
                                                  to_tp_params,
                                                  tp_consts_specs,
                                                  tp_param_specs)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs >=4 devices")


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32),
            jnp.asarray(rng.uniform(size=(n, 1)), jnp.float32))


def _synth_pointset(n, seed, noise=0.0):
    """Shared synthetic field for the TP-vs-fit parity tests — one
    definition so the three parity tests can't silently diverge."""
    from st_dadk_tpu.dataio.arrays import PointSet
    r = np.random.default_rng(seed)
    coords = r.uniform(size=(n, 2)).astype(np.float32)
    t = r.uniform(size=(n, 1)).astype(np.float32)
    y = np.sin(3 * coords[:, :1]) + 0.5 * t
    if noise:
        y = y + r.normal(0, noise, (n, 1))
    return PointSet(coords=coords, t=t, y=y.astype(np.float32),
                    w=np.ones(n, np.float32), n_real=n)


@pytest.mark.parametrize("learnable,delta", [(False, False), (True, False),
                                             (True, True)])
def test_tp_matches_unsharded(learnable, delta):
    n_dev = 4
    mesh = make_mesh({"tp": n_dev}, jax.devices()[:n_dev])
    spec = ModelSpec(k_spatial_centers=(25, 81), k_temporal_centers=(4, 6),
                     hidden_dims=(32, 16), dropout=0.0,
                     spatial_learnable=learnable,
                     output_dim=5 if delta else 1,
                     use_delta_reparameterization=delta)
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    coords, t = _inputs(96, 1)

    want = np.asarray(forward(spec, params, consts, None, coords, t))

    tp_params, tp_consts = to_tp_params(spec, params, consts, n_dev)
    # 106 centers pad to 108? -> to multiple of 4 = 108
    assert tp_params["mlp"]["w0_spatial"].shape[0] % n_dev == 0
    tp_params = place_tp(tp_params, tp_param_specs(spec), mesh)
    tp_consts = place_tp(tp_consts, tp_consts_specs(), mesh)
    fwd = make_tp_forward(spec, mesh)
    got = np.asarray(fwd(tp_params, tp_consts, coords, t))

    assert got.shape == want.shape
    assert np.allclose(got, want, atol=5e-5), np.abs(got - want).max()


def test_tp_rejects_covariates():
    spec = ModelSpec(p=3, k_spatial_centers=(9,), k_temporal_centers=(4,),
                     hidden_dims=(8,), dropout=0.0)
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    with pytest.raises(NotImplementedError):
        to_tp_params(spec, params, consts, 4)


class TestTPTrainStep:
    def test_one_step_matches_unsharded(self):
        """A TP train step must update parameters identically (up to f32
        noise) to the unsharded step on the same replicated batch."""
        from st_dadk_tpu.parallel.tensor_parallel import (
            make_tp_train_step, to_tp_params, tp_param_specs,
            tp_consts_specs, place_tp)
        from st_dadk_tpu.train.optimizer import (adamw_init, adamw_update,
                                                 lr_tree_for)
        from st_dadk_tpu.ops.losses import mse_loss
        from st_dadk_tpu.models.st_interp import forward

        n_dev = 4
        mesh = make_mesh({"tp": n_dev}, jax.devices()[:n_dev])
        spec = ModelSpec(k_spatial_centers=(25, 81), k_temporal_centers=(4,),
                         hidden_dims=(32, 16), dropout=0.0,
                         spatial_learnable=True)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        rng = np.random.default_rng(2)
        coords = jnp.asarray(rng.uniform(size=(64, 2)), jnp.float32)
        t = jnp.asarray(rng.uniform(size=(64, 1)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(64, 1)), jnp.float32)
        w = jnp.ones((64,), jnp.float32)
        lrs = jnp.asarray([1e-2, 1e-3], jnp.float32)

        # unsharded single step (same loss: mse + domain penalty weight 0.01)
        def loss_fn(p):
            preds = forward(spec, p, consts, None, coords, t, train=False)
            loss = mse_loss(preds, y, w)
            c = p["basis"]["centers"]
            viol = jax.nn.relu(-c) + jax.nn.relu(c - 1.0)
            return loss + 0.01 * jnp.sum(viol ** 2)

        loss_ref, grads = jax.value_and_grad(loss_fn)(params)
        p_ref, _ = adamw_update(params, grads, adamw_init(params),
                                lr_tree_for(params, lrs[0], lrs[1]), 0.0)

        # TP step
        tp_params, tp_consts = to_tp_params(spec, params, consts, n_dev)
        tp_params = place_tp(tp_params, tp_param_specs(spec), mesh)
        tp_consts = place_tp(tp_consts, tp_consts_specs(), mesh)
        tp_opt = adamw_init(tp_params)
        step = make_tp_train_step(spec, mesh, domain_penalty_weight=0.01)
        tp_new, _, loss_tp = step(tp_params, tp_opt, tp_consts, coords, t, y,
                                  w, lrs, None)

        assert np.isclose(float(loss_tp), float(loss_ref), rtol=1e-5)
        # sharded leaves: compare the real (unpadded) rows
        k = spec.k_spatial
        got_w0 = np.asarray(tp_new["mlp"]["w0_spatial"])[:k]
        want_w0 = np.asarray(p_ref["mlp"]["linear_0"]["w"])[:k]
        assert np.allclose(got_w0, want_w0, atol=5e-5)
        got_c = np.asarray(tp_new["basis"]["centers"])[:k]
        want_c = np.asarray(p_ref["basis"]["centers"])
        assert np.allclose(got_c, want_c, atol=5e-5)
        # replicated leaves
        assert np.allclose(np.asarray(tp_new["mlp"]["linear_1"]["w"]),
                           np.asarray(p_ref["mlp"]["linear_1"]["w"]),
                           atol=5e-5)

    def test_full_tp_training_loop_matches_fit(self):
        """fit_tp runs the COMPLETE machinery (LR tables, EMA, EMA-swap
        validation, early stopping) with the basis axis sharded; with
        identical seeds/batches it must track the unsharded fit() and keep
        pad rows inert (k=106 on 4 devices -> 2 pads)."""
        from st_dadk_tpu.config import ExperimentConfig
        from st_dadk_tpu.models.st_interp import (forward, init_model,
                                                  spec_from_config)
        from st_dadk_tpu.parallel.tensor_parallel import fit_tp
        from st_dadk_tpu.train.loop import fit

        synth = _synth_pointset

        cfg = ExperimentConfig.from_dict(dict(
            k_spatial_centers=[25, 81], k_temporal_centers=[5],
            hidden_dims=[32, 16], dropout=0.0, epochs=8, lr=1e-2,
            batch_size=64, patience=100, warmup_epochs=2, scheduler="cosine",
            grad_clip=0.0, weight_decay=1e-5, regression_type="mean",
            spatial_learnable=True, domain_penalty_weight=0.01))
        spec_m = spec_from_config(cfg)
        assert spec_m.k_spatial % 4 != 0
        params, consts = init_model(jax.random.PRNGKey(0), spec_m)
        train_ps, valid_ps = synth(256, 1), synth(64, 2)

        r_ref = fit(cfg, spec_m, params, consts, train_ps, valid_ps, seed=3,
                    epochs_chunk=8)
        mesh = make_mesh({"tp": 4}, jax.devices()[:4])
        r_tp = fit_tp(cfg, spec_m, params, consts, train_ps, valid_ps, mesh,
                      seed=3)

        assert r_tp.n_epochs_run == r_ref.n_epochs_run
        # same batches/LR/EMA; the psum reduction order drifts f32 rounding,
        # which compounds on an exponentially-decaying loss — tolerances are
        # absolute-dominated once the loss is ~1e-4
        np.testing.assert_allclose(r_tp.history["train_loss"],
                                   r_ref.history["train_loss"],
                                   rtol=0.02, atol=5e-4)
        np.testing.assert_allclose(r_tp.history["val_rmse"],
                                   r_ref.history["val_rmse"],
                                   rtol=0.02, atol=5e-4)
        # reconstructed unsharded params produce matching forwards
        coords, t = _inputs(64, 9)
        got = np.asarray(forward(spec_m, r_tp.params, consts, None,
                                 coords, t))
        want = np.asarray(forward(spec_m, r_ref.params, consts, None,
                                  coords, t))
        # accumulated f32 drift over 8 epochs; the fields agree to ~2%
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
        err = np.abs(got - want).mean()
        assert err < 0.02, err

    def test_tp_single_quantile_tracks_fit(self):
        """regression_type='quantile' must train the CHECK loss on the TP
        path too (regression: it silently fell back to MSE)."""
        from st_dadk_tpu.config import ExperimentConfig
        from st_dadk_tpu.models.st_interp import init_model, spec_from_config
        from st_dadk_tpu.parallel.tensor_parallel import fit_tp
        from st_dadk_tpu.train.loop import fit

        def synth(n, seed):
            return _synth_pointset(n, seed, noise=0.1)

        cfg = ExperimentConfig.from_dict(dict(
            k_spatial_centers=[25], k_temporal_centers=[5],
            hidden_dims=[16], dropout=0.0, epochs=4, lr=1e-2,
            batch_size=64, patience=100, warmup_epochs=1, scheduler="cosine",
            grad_clip=0.0, weight_decay=1e-5, regression_type="quantile",
            quantile_levels=[0.9], current_quantile=0.9,
            spatial_learnable=False))
        spec_m = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(0), spec_m)
        train_ps, valid_ps = synth(256, 1), synth(64, 2)
        r_ref = fit(cfg, spec_m, params, consts, train_ps, valid_ps, seed=3,
                    epochs_chunk=4)
        mesh = make_mesh({"tp": 4}, jax.devices()[:4])
        r_tp = fit_tp(cfg, spec_m, params, consts, train_ps, valid_ps, mesh,
                      seed=3)
        np.testing.assert_allclose(r_tp.history["train_loss"],
                                   r_ref.history["train_loss"],
                                   rtol=0.02, atol=5e-4)

    def test_tp_quantile_tau_defaults_to_first_level(self):
        """current_quantile=None must default to quantile_levels[0] like the
        sequential engine's substitution (train/experiment.py), not to the
        median (regression: a 0.5 fallback silently fit the wrong tau for
        e.g. levels=[0.9])."""
        from st_dadk_tpu.ops.losses import quantile_loss
        from st_dadk_tpu.parallel.tensor_parallel import _tp_supported_loss
        preds = jnp.asarray([[0.2], [0.7]])
        y = jnp.asarray([[0.5], [0.1]])
        w = jnp.ones(2, jnp.float32)
        fn = _tp_supported_loss("quantile", [0.9], None)
        np.testing.assert_allclose(float(fn(preds, y, w)),
                                   float(quantile_loss(preds, y, 0.9, w)),
                                   rtol=1e-6)

    def test_tp_all_penalties_track_fit(self):
        """The full composite objective — delta P_nc, movement, sparsity
        (sharded spatial block via psum + replicated temporal), domain — on
        the TP layout must track the replicated fit() (regression: sparsity/
        movement/non-crossing used to be silently DROPPED on this path)."""
        from st_dadk_tpu.config import ExperimentConfig
        from st_dadk_tpu.models.st_interp import init_model, spec_from_config
        from st_dadk_tpu.parallel.tensor_parallel import fit_tp
        from st_dadk_tpu.train.loop import fit

        synth = _synth_pointset

        cfg = ExperimentConfig.from_dict(dict(
            k_spatial_centers=[25], k_temporal_centers=[5],
            hidden_dims=[16], dropout=0.0, epochs=4, lr=1e-2,
            batch_size=64, patience=100, warmup_epochs=1, scheduler="cosine",
            grad_clip=0.0, weight_decay=1e-5,
            regression_type="multi-quantile",
            quantile_levels=[0.05, 0.5, 0.95],
            use_delta_reparameterization=True, non_crossing_lambda=1.0,
            spatial_learnable=True, basis_unfreeze_epoch=0,
            domain_penalty_weight=0.01, movement_penalty_weight=0.001,
            sparsity_penalty_type="sparse_group",
            sparsity_lambda_l1=1e-4, sparsity_lambda_group=1e-4))
        spec_m = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(0), spec_m)
        train_ps, valid_ps = synth(256, 1), synth(64, 2)
        r_ref = fit(cfg, spec_m, params, consts, train_ps, valid_ps, seed=3,
                    epochs_chunk=4)
        mesh = make_mesh({"tp": 4}, jax.devices()[:4])
        r_tp = fit_tp(cfg, spec_m, params, consts, train_ps, valid_ps, mesh,
                      seed=3)
        np.testing.assert_allclose(r_tp.history["train_loss"],
                                   r_ref.history["train_loss"],
                                   rtol=0.02, atol=5e-4)
        np.testing.assert_allclose(r_tp.history["val_loss"],
                                   r_ref.history["val_loss"],
                                   rtol=0.02, atol=5e-4)

    def test_multi_step_pads_stay_inert(self):
        """With k % n_dev != 0 (25+81=106 centers on 4 devices -> 2 pad
        rows), several TP train steps must (a) keep the pad rows exactly at
        their initial values — zero w0 rows, 0.5 centers — and (b) track the
        unsharded training trajectory. Regression test for the phantom-basis
        bug: unmasked pad rows of w0_spatial receive nonzero gradient (phi
        at the pad centers covers the whole domain) and drift off zero."""
        from st_dadk_tpu.parallel.tensor_parallel import (
            make_tp_train_step, to_tp_params, tp_param_specs,
            tp_consts_specs, place_tp, make_tp_forward)
        from st_dadk_tpu.train.optimizer import (adamw_init, adamw_update,
                                                 lr_tree_for)
        from st_dadk_tpu.ops.losses import mse_loss
        from st_dadk_tpu.models.st_interp import forward

        n_dev = 4
        n_steps = 5
        wd = 0.05   # nonzero weight decay exercises the pad-row pinning
        mesh = make_mesh({"tp": n_dev}, jax.devices()[:n_dev])
        spec = ModelSpec(k_spatial_centers=(25, 81), k_temporal_centers=(4,),
                         hidden_dims=(32, 16), dropout=0.0,
                         spatial_learnable=True)
        assert spec.k_spatial % n_dev != 0
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        rng = np.random.default_rng(2)
        coords = jnp.asarray(rng.uniform(size=(64, 2)), jnp.float32)
        t = jnp.asarray(rng.uniform(size=(64, 1)), jnp.float32)
        y = jnp.asarray(rng.normal(size=(64, 1)), jnp.float32)
        w = jnp.ones((64,), jnp.float32)
        lrs = jnp.asarray([1e-2, 1e-3], jnp.float32)

        def loss_fn(p):
            preds = forward(spec, p, consts, None, coords, t, train=False)
            loss = mse_loss(preds, y, w)
            c = p["basis"]["centers"]
            viol = jax.nn.relu(-c) + jax.nn.relu(c - 1.0)
            return loss + 0.01 * jnp.sum(viol ** 2)

        p_ref, opt_ref = params, adamw_init(params)
        for _ in range(n_steps):
            _, grads = jax.value_and_grad(loss_fn)(p_ref)
            p_ref, opt_ref = adamw_update(
                p_ref, grads, opt_ref, lr_tree_for(p_ref, lrs[0], lrs[1]), wd)

        tp_params, tp_consts = to_tp_params(spec, params, consts, n_dev)
        tp_params = place_tp(tp_params, tp_param_specs(spec), mesh)
        tp_consts = place_tp(tp_consts, tp_consts_specs(), mesh)
        tp_opt = adamw_init(tp_params)
        step = make_tp_train_step(spec, mesh, domain_penalty_weight=0.01,
                                  weight_decay=wd)
        for _ in range(n_steps):
            tp_params, tp_opt, _ = step(tp_params, tp_opt, tp_consts, coords,
                                        t, y, w, lrs, None)

        k = spec.k_spatial
        # (a) pads exactly at init: zero weight rows, centers 0.5, log_bw 0
        w0 = np.asarray(tp_params["mlp"]["w0_spatial"])
        assert np.all(w0[k:] == 0.0), np.abs(w0[k:]).max()
        c = np.asarray(tp_params["basis"]["centers"])
        assert np.all(c[k:] == 0.5)
        lb = np.asarray(tp_params["basis"]["log_bandwidths"])
        assert np.all(lb[k:] == 0.0)
        # (b) trajectory parity on the real rows and replicated leaves
        assert np.allclose(w0[:k], np.asarray(p_ref["mlp"]["linear_0"]["w"])[:k],
                           atol=2e-4), \
            np.abs(w0[:k] - np.asarray(p_ref["mlp"]["linear_0"]["w"])[:k]).max()
        assert np.allclose(c[:k], np.asarray(p_ref["basis"]["centers"]),
                           atol=2e-4)
        # (c) TP forward after training still matches the unsharded forward
        fwd = make_tp_forward(spec, mesh)
        got = np.asarray(fwd(tp_params, tp_consts, coords, t))
        want = np.asarray(forward(spec, p_ref, consts, None, coords, t))
        assert np.allclose(got, want, atol=5e-4), np.abs(got - want).max()
