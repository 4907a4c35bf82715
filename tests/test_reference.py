"""The plain reference (st_dadk_tpu/reference.py) against the engine's model
and loss at small widths; the suite runs every matmul at "highest"
(conftest), so both sides are float32 and only summation order differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu import reference as ref
from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.models.st_interp import (_dropout_masks, forward,
                                          init_model, spec_from_config)
from st_dadk_tpu.train.loop import LoopSpec, training_loss

N = 96
CASES = {
    "wendland-learnable-multiq": dict(
        spatial_basis_function="wendland", spatial_learnable=True,
        regression_type="multi-quantile",
        quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
        domain_penalty_weight=0.5, sparsity_penalty_type="sparse_group",
        sparsity_lambda_l1=1e-3, sparsity_lambda_group=1e-2,
        sparsity_apply_to_temporal=False),
    "gaussian-fixed-mean": dict(
        spatial_basis_function="gaussian", spatial_learnable=False,
        regression_type="mean", sparsity_penalty_type="element",
        sparsity_lambda_l1=1e-3),
    "triangular-quantile": dict(
        spatial_basis_function="triangular", spatial_learnable=True,
        regression_type="quantile", quantile_levels=[0.3],
        current_quantile=0.3, movement_penalty_weight=0.2,
        sparsity_penalty_type="group", sparsity_lambda_group=1e-2),
    "delta-head": dict(
        spatial_basis_function="wendland", spatial_learnable=True,
        regression_type="multi-quantile", quantile_levels=[0.1, 0.5, 0.9],
        use_delta_reparameterization=True, domain_penalty_weight=0.01),
    "no-layernorm-no-dropout": dict(
        spatial_basis_function="wendland", spatial_learnable=True,
        regression_type="multi-quantile", quantile_levels=[0.25, 0.75],
        layernorm=False, dropout=0.0),
}


def _setup(case):
    cfg = ExperimentConfig.from_dict({
        "k_spatial_centers": [4, 9], "k_temporal_centers": [3, 5],
        "hidden_dims": [16, 8], "dropout": 0.1, **CASES[case]})
    spec = spec_from_config(cfg)
    rng = np.random.default_rng(len(case))
    centers = rng.uniform(size=(spec.k_spatial, 2)).astype(np.float32)
    bw = rng.uniform(0.2, 0.6, spec.k_spatial).astype(np.float32)
    params, consts = init_model(jax.random.PRNGKey(3), spec, centers, bw)
    if cfg.spatial_learnable:
        # move centres off their init (movement penalty) and partly out of
        # the unit square (domain penalty)
        params["basis"]["centers"] = params["basis"]["centers"] * 1.3 - 0.1
    c = jnp.asarray(rng.uniform(size=(N, 2)), jnp.float32)
    t = jnp.asarray(rng.uniform(size=(N, 1)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((N, 1)), jnp.float32)
    w = jnp.asarray(rng.uniform(size=N) < 0.8, jnp.float32)
    return cfg, spec, params, consts, (c, t, y, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_engine(case):
    cfg, spec, params, consts, (c, t, _, _) = _setup(case)
    got = ref.forward(cfg, params, consts, c, t)
    want = forward(spec, params, consts, None, c, t, train=False)
    assert got.shape == want.shape == (N, cfg.output_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_engine(case):
    cfg, spec, params, consts, (c, t, y, w) = _setup(case)
    key = jax.random.PRNGKey(11)
    keep = _dropout_masks(spec, key, N) if cfg.dropout > 0 else None
    lspec = LoopSpec.from_config(cfg, spec, N, 1, N, 1)
    loss_e, grad_e = jax.value_and_grad(
        lambda p: training_loss(lspec, p, consts, c, t, y, w, True, key))(
            params)
    loss_r, grad_r = ref.loss_and_grad(cfg, params, consts, c, t, y, w, keep)
    np.testing.assert_allclose(loss_r, loss_e, rtol=1e-5)
    flat_e = dict(jax.tree_util.tree_leaves_with_path(grad_e))
    for path, g in jax.tree_util.tree_leaves_with_path(grad_r):
        np.testing.assert_allclose(
            g, flat_e[path], atol=1e-5 * (1 + float(jnp.abs(g).max())),
            rtol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_unmodelled_options_are_refused():
    cfg, _, params, consts, (c, t, _, _) = _setup("delta-head")
    with pytest.raises(NotImplementedError):
        ref.forward(cfg.replace(non_crossing_lambda=1.0), params, consts,
                    c, t)
    with pytest.raises(NotImplementedError):
        ref.forward(cfg.replace(k_spatial_pad=20), params, consts, c, t)


@pytest.mark.parametrize("kind", ["wendland", "gaussian", "triangular"])
def test_basis_values(kind):
    r = jnp.asarray([0.0, 0.5, 1.0, 1.5], jnp.float32)
    v = np.asarray(ref.basis_fn(r, kind))
    assert v[0] == pytest.approx(1.0)
    if kind == "gaussian":
        np.testing.assert_allclose(v, np.exp(-0.5 * np.asarray(r) ** 2),
                                   rtol=1e-6)
    else:
        assert v[2] == 0.0 and v[3] == 0.0       # compact support
        assert 0.0 < v[1] < 1.0
