"""Model structural tests (mirrors the reference's tiny-config test tier,
tests/stnf/models/test_st_interp_delta_reparameterization.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu.models.st_interp import (
    ModelSpec,
    count_parameters,
    domain_penalty,
    forward,
    init_model,
    movement_penalty,
    sparsity_penalty,
    spatial_params,
)

TINY = dict(k_spatial_centers=(9,), k_temporal_centers=(5,),
            hidden_dims=(32, 16), dropout=0.0)


def _make(spec):
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    return params, consts


class TestForward:
    def test_shapes_mean(self):
        spec = ModelSpec(output_dim=1, **TINY)
        params, consts = _make(spec)
        coords = jnp.asarray(np.random.default_rng(0).uniform(size=(7, 2)),
                             dtype=jnp.float32)
        t = jnp.zeros((7, 1))
        out = forward(spec, params, consts, None, coords, t)
        assert out.shape == (7, 1)
        assert np.all(np.isfinite(np.asarray(out)))

    def test_shapes_multiquantile_direct(self):
        spec = ModelSpec(output_dim=5, **TINY)
        params, consts = _make(spec)
        coords = jnp.ones((3, 2)) * 0.5
        out = forward(spec, params, consts, None, coords, jnp.zeros((3, 1)))
        assert out.shape == (3, 5)

    def test_delta_head_structure(self):
        spec = ModelSpec(output_dim=5, use_delta_reparameterization=True, **TINY)
        params, consts = _make(spec)
        assert "delta" in params["mlp"]
        assert "out" not in params["mlp"]
        assert params["mlp"]["delta"].shape == (5, 16 + 1)

    def test_delta_cumsum_closed_form(self):
        """yhat_k must equal beta_k0 + h . beta_k where beta_k = sum_{l<=k} delta_l
        (ref st_interp.py:849-877 verified against closed form)."""
        spec = ModelSpec(output_dim=3, use_delta_reparameterization=True, **TINY)
        params, consts = _make(spec)
        coords = jnp.asarray(np.random.default_rng(1).uniform(size=(4, 2)),
                             dtype=jnp.float32)
        t = jnp.full((4, 1), 0.3)
        # pin f32 matmuls: the comparison target is float64 numpy, and an
        # accelerator's default matmul precision (TF32 on a GPU) would dominate the
        # 1e-5 tolerance (this test asserts cumsum/closed-form EQUIVALENCE,
        # not the backend's matmul precision)
        with jax.default_matmul_precision("highest"):
            out = np.asarray(forward(spec, params, consts, None, coords, t))

            # independent recomputation: trunk output via forward of a spec
            # with the same params but direct head replaced by identity is
            # not exposed; recompute trunk manually
            from st_dadk_tpu.models.st_interp import _embed, trunk
            phi, psi = _embed(spec, params, consts, coords, t)
            h = np.asarray(trunk(spec, params,
                                 jnp.concatenate([phi, psi], -1)))
        delta = np.asarray(params["mlp"]["delta"])
        beta = np.cumsum(delta, axis=0)
        expected = np.stack(
            [beta[k, 0] + h @ beta[k, 1:] for k in range(3)], axis=1)
        assert np.allclose(out, expected, atol=1e-5)

    def test_determinism(self):
        spec = ModelSpec(**TINY)
        params, consts = _make(spec)
        coords = jnp.ones((2, 2)) * 0.25
        t = jnp.zeros((2, 1))
        o1 = forward(spec, params, consts, None, coords, t)
        o2 = forward(spec, params, consts, None, coords, t)
        assert np.array_equal(np.asarray(o1), np.asarray(o2))

    def test_dropout_train_vs_eval(self):
        spec = ModelSpec(k_spatial_centers=(9,), k_temporal_centers=(5,),
                         hidden_dims=(32, 16), dropout=0.5)
        params, consts = _make(spec)
        coords = jnp.ones((64, 2)) * 0.5
        t = jnp.zeros((64, 1))
        e = forward(spec, params, consts, None, coords, t, train=False)
        tr = forward(spec, params, consts, None, coords, t, train=True,
                     rng=jax.random.PRNGKey(3))
        assert not np.allclose(np.asarray(e), np.asarray(tr))

    def test_covariates_concat(self):
        spec = ModelSpec(p=3, **TINY)
        params, consts = _make(spec)
        X = jnp.zeros((5, 3))
        out = forward(spec, params, consts, X, jnp.ones((5, 2)) * 0.5,
                      jnp.zeros((5, 1)))
        assert out.shape == (5, 1)


class TestLearnableBasis:
    def test_param_layout(self):
        spec = ModelSpec(spatial_learnable=True, **TINY)
        params, consts = _make(spec)
        assert params["basis"]["centers"].shape == (9, 2)
        assert params["basis"]["log_bandwidths"].shape == (9,)
        c, bw = spatial_params(spec, params, consts)
        # exp(log(bw)) roundtrip; rtol guards against fast-math exp/log
        assert np.allclose(np.asarray(bw),
                           np.asarray(consts["spatial_bandwidths_init"]),
                           rtol=1e-4)

    def test_domain_penalty(self):
        spec = ModelSpec(spatial_learnable=True, **TINY)
        params, consts = _make(spec)
        assert float(domain_penalty(spec, params)) == 0.0  # grid inside [0,1]^2
        params["basis"]["centers"] = params["basis"]["centers"] + 2.0
        # all 18 coordinates violate by (c+2) - 1 = c + 1
        c = np.asarray(consts["spatial_centers_init"])
        expected = np.sum((c + 1.0) ** 2)
        assert np.isclose(float(domain_penalty(spec, params)), expected, rtol=1e-5)

    def test_movement_penalty(self):
        spec = ModelSpec(spatial_learnable=True, **TINY)
        params, consts = _make(spec)
        assert float(movement_penalty(spec, params, consts)) == 0.0
        params["basis"]["centers"] = params["basis"]["centers"] + 0.1
        assert np.isclose(float(movement_penalty(spec, params, consts)),
                          18 * 0.01, rtol=1e-4)

    def test_fixed_basis_has_no_basis_params(self):
        spec = ModelSpec(spatial_learnable=False, **TINY)
        params, _ = _make(spec)
        assert "basis" not in params


class TestSparsity:
    def test_element_l1(self):
        spec = ModelSpec(**TINY)
        params, _ = _make(spec)
        pen = sparsity_penalty(spec, params, "element", 0.5, 0.0)
        w0 = np.asarray(params["mlp"]["linear_0"]["w"])
        expected_sp = 0.5 * np.abs(w0[:9]).sum()
        expected_tp = 0.5 * np.abs(w0[9:14]).sum()
        assert np.isclose(float(pen["spatial_penalty"]), expected_sp, rtol=1e-5)
        assert np.isclose(float(pen["temporal_penalty"]), expected_tp, rtol=1e-5)
        assert np.isclose(float(pen["total_penalty"]),
                          expected_sp + expected_tp, rtol=1e-5)

    def test_group_lasso(self):
        spec = ModelSpec(**TINY)
        params, _ = _make(spec)
        pen = sparsity_penalty(spec, params, "group", 0.0, 2.0)
        w0 = np.asarray(params["mlp"]["linear_0"]["w"])
        expected = 2.0 * np.linalg.norm(w0[:9], axis=1).sum()
        assert np.isclose(float(pen["spatial_penalty"]), expected, rtol=1e-5)

    def test_none_and_errors(self):
        spec = ModelSpec(**TINY)
        params, _ = _make(spec)
        pen = sparsity_penalty(spec, params, "none", 1.0, 1.0)
        assert float(pen["total_penalty"]) == 0.0
        with pytest.raises(ValueError):
            sparsity_penalty(spec, params, "nuclear", 1.0, 1.0)

    def test_sparse_group_combines(self):
        spec = ModelSpec(**TINY)
        params, _ = _make(spec)
        e = sparsity_penalty(spec, params, "element", 0.3, 0.0)
        g = sparsity_penalty(spec, params, "group", 0.0, 0.7)
        sg = sparsity_penalty(spec, params, "sparse_group", 0.3, 0.7)
        assert np.isclose(float(sg["total_penalty"]),
                          float(e["total_penalty"]) + float(g["total_penalty"]),
                          rtol=1e-5)

    def test_delta_head_uses_trunk_first_layer(self):
        spec = ModelSpec(output_dim=3, use_delta_reparameterization=True, **TINY)
        params, _ = _make(spec)
        pen = sparsity_penalty(spec, params, "sparse_group", 0.01, 0.01)
        assert float(pen["total_penalty"]) > 0.0


class TestInit:
    def test_param_count_vs_reference_formula(self):
        # default config: input 227+70=297 -> 256 -> 256 -> 128 -> 1
        spec = ModelSpec()
        params, _ = _make(spec)
        expected = (297 * 256 + 256) + (256 + 256) + (256 * 256 + 256) + \
                   (256 + 256) + (256 * 128 + 128) + (128 + 128) + (128 + 1)
        assert count_parameters(params) == expected

    def test_weight_init_range(self):
        spec = ModelSpec(**TINY)
        params, _ = _make(spec)
        w = np.asarray(params["mlp"]["linear_0"]["w"])
        bound = 1.0 / np.sqrt(14)  # fan_in = 9 + 5
        assert w.min() >= -bound and w.max() <= bound

    def test_custom_centers_passed_through(self):
        spec = ModelSpec(spatial_learnable=True, **TINY)
        centers = np.random.default_rng(2).uniform(size=(9, 2)).astype(np.float32)
        bw = np.full(9, 0.3, np.float32)
        params, consts = init_model(jax.random.PRNGKey(0), spec, centers, bw)
        assert np.allclose(np.asarray(params["basis"]["centers"]), centers)
        assert np.allclose(np.asarray(jnp.exp(params["basis"]["log_bandwidths"])),
                           bw, rtol=1e-4)
