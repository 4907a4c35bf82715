"""Odds and ends: covariate path, JSON-safe persistence, config round-trip,
seed util, legacy basis."""
import json

import jax
import jax.numpy as jnp
import numpy as np

from st_dadk_tpu.config import ExperimentConfig, load_config
from st_dadk_tpu.models.st_interp import ModelSpec, forward, init_model
from st_dadk_tpu.models import legacy_basis
from st_dadk_tpu.utils.io import json_safe, save_json
from st_dadk_tpu.utils.seed import set_seed


class TestCovariatePath:
    def test_forward_with_covariates(self):
        spec = ModelSpec(p=3, k_spatial_centers=(9,), k_temporal_centers=(4,),
                         hidden_dims=(16, 8), dropout=0.0)
        params, consts = init_model(jax.random.PRNGKey(0), spec)
        assert params["mlp"]["linear_0"]["w"].shape[0] == 3 + 9 + 4
        X = jnp.ones((5, 3)) * 0.5
        out = forward(spec, params, consts, X, jnp.ones((5, 2)) * 0.5,
                      jnp.zeros((5, 1)))
        out0 = forward(spec, params, consts, jnp.zeros((5, 3)),
                       jnp.ones((5, 2)) * 0.5, jnp.zeros((5, 1)))
        # covariates actually influence the output
        assert not np.allclose(np.asarray(out), np.asarray(out0))


class TestJsonSafe:
    def test_converts_numpy_and_jax(self, tmp_path):
        obj = {"a": np.float32(1.5), "b": np.arange(3),
               "c": jnp.ones(2), "d": {"e": np.bool_(True)},
               "f": [np.int64(7)], "g": tmp_path}
        s = json_safe(obj)
        json.dumps(s)  # must not raise
        assert s["a"] == 1.5 and s["b"] == [0, 1, 2]
        assert s["d"]["e"] is True and s["f"] == [7]
        save_json(obj, tmp_path / "x.json")
        assert json.load(open(tmp_path / "x.json"))["c"] == [1.0, 1.0]


class TestConfig:
    def test_yaml_roundtrip(self, tmp_path):
        cfg = ExperimentConfig(tag="rt", lr=2e-2, epochs=77,
                               quantile_levels=[0.1, 0.9])
        cfg.extra["custom_key"] = 42
        p = tmp_path / "c.yaml"
        cfg.to_yaml(p)
        back = ExperimentConfig.from_yaml(p)
        assert back.tag == "rt" and back.epochs == 77
        assert back.lr == 2e-2
        assert back.extra["custom_key"] == 42

    def test_load_config_overrides(self, tmp_path):
        p = tmp_path / "c.yaml"
        ExperimentConfig(epochs=10).to_yaml(p)
        cfg = load_config(p, {"epochs": 20, "data_file": None})
        assert cfg.epochs == 20          # override applied
        assert cfg.data_file == ExperimentConfig().data_file  # None ignored

    def test_string_scientific_notation(self):
        cfg = ExperimentConfig.from_dict({"lr": "2e-2", "weight_decay": "5e-4"})
        assert cfg.lr == 0.02 and cfg.weight_decay == 0.0005


class TestSeedUtil:
    def test_set_seed(self):
        key = set_seed(123)
        a = np.random.rand(3)
        set_seed(123)
        b = np.random.rand(3)
        assert np.array_equal(a, b)
        assert key.shape == () or key.shape == (2,)  # typed or raw key


class TestLegacyBasis:
    def test_grids_and_embed(self):
        # NOTE: the reference module's docstring claims 250 centers but its
        # grid configs (5x5 + 9x9 + 11x11) actually build 227
        # (basis_embedding.py:86-90); we match the actual behavior.
        centers, bws = legacy_basis.legacy_centers_and_bandwidths()
        assert centers.shape == (227, 2)
        # reference theta values per resolution
        assert np.isclose(bws[0], 0.625)
        assert np.isclose(bws[25], 0.3125)
        assert np.isclose(bws[106], 0.25)
        phi = legacy_basis.embed(jnp.asarray([[0.5, 0.5]], jnp.float32))
        assert phi.shape == (1, 227)
        assert float(phi.max()) <= 1.0 + 1e-6

