"""Plateau-slope early stop (config.early_stop_min_rel_delta, opt-in).

The mixed-grid critical path is configs whose validation keeps improving
marginally for the full epoch cap;
the knob thresholds the patience reset on a relative-significance margin.
Contract under test:
  - 0.0 (default) reproduces the reference's any-improvement patience
    BIT-EXACTLY (the sig anchor then tracks best_val),
  - d > 0 stops a marginally-improving lane after `patience` epochs while
    best_val / best-EMA still track the TRUE best,
  - the TP engine refuses the knob loudly instead of silently diverging.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet
from st_dadk_tpu.models.st_interp import init_model, spec_from_config
from st_dadk_tpu.train.loop import (LoopSpec, _epoch_bookkeeping, fit,
                                    init_carry)


def _scalar_carry(best=np.inf, sig=np.inf, pat=0, stopped=False):
    return {
        "best_val": jnp.asarray(best, jnp.float32),
        "sig_best": jnp.asarray(sig, jnp.float32),
        "has_best": jnp.asarray(np.isfinite(best)),
        "patience_ctr": jnp.asarray(pat, jnp.int32),
        "stopped": jnp.asarray(stopped),
        "stop_epoch": jnp.asarray(0, jnp.int32),
        "key": jax.random.PRNGKey(0),
    }


def _spec(patience, d):
    from st_dadk_tpu.models.st_interp import ModelSpec
    return LoopSpec(model=ModelSpec(k_spatial_centers=(9,),
                                    k_temporal_centers=(4,),
                                    hidden_dims=(8,)),
                    patience=patience, min_rel_delta=d)


def _run_sequence(vals, patience, d):
    """Feed a val-loss sequence through _epoch_bookkeeping; return the
    (patience_ctr, stopped, best_val) trajectories."""
    spec = _spec(patience, d)
    carry = _scalar_carry()
    out = []
    for e, v in enumerate(vals):
        _, _, scal = _epoch_bookkeeping(
            spec, carry, jnp.asarray(v, jnp.float32),
            jnp.asarray(e, jnp.int32), jnp.asarray(True))
        carry = {**carry, **scal}
        out.append((int(carry["patience_ctr"]), bool(carry["stopped"]),
                    float(carry["best_val"])))
    return out


class TestBookkeepingSemantics:
    def test_zero_delta_equals_any_improvement_patience(self):
        """d=0.0 must reproduce the reference patience trajectory exactly
        on random sequences (the pre-knob code's semantics, modeled here
        in plain numpy)."""
        rng = np.random.default_rng(7)
        for _ in range(5):
            vals = rng.uniform(0.1, 2.0, size=40).astype(np.float32)
            got = _run_sequence(vals, patience=5, d=0.0)
            # reference model: patience resets on ANY new best
            best, pat, stopped = np.inf, 0, False
            for e, v in enumerate(vals):
                if not stopped:
                    if v < best:
                        best, pat = v, 0
                    else:
                        pat += 1
                    stopped = stopped or pat >= 5
                assert got[e] == (pat, stopped, np.float32(best)), (e, vals)

    def test_marginal_improvements_stop_with_delta(self):
        """A sequence improving 0.01% per epoch: d=0 never stops; d=1e-3
        stops after exactly `patience` epochs past the anchor."""
        vals = 1.0 * (1 - 1e-4) ** np.arange(30)
        got0 = _run_sequence(vals, patience=5, d=0.0)
        assert not any(s for _, s, _ in got0)
        gotd = _run_sequence(vals, patience=5, d=1e-3)
        # epoch 0 sets the anchor at 1.0; every later epoch improves by
        # <0.1% cumulative within 5 epochs -> stop at epoch index 5
        assert [s for _, s, _ in gotd].index(True) == 5
        # best_val still tracks the true minimum up to the stop epoch
        assert gotd[5][2] == np.float32(min(vals[:6]))

    def test_significant_improvement_resets(self):
        """Improvements bigger than d keep the lane alive; the anchor
        ratchets so repeated significant steps never stop."""
        vals = 1.0 * (0.9 ** np.arange(20))     # -10% per epoch
        gotd = _run_sequence(vals, patience=3, d=0.01)
        assert not any(s for _, s, _ in gotd)
        assert all(p == 0 for p, _, _ in gotd)

    def test_stopped_lane_keeps_state(self):
        vals = [1.0, 1.0, 1.0, 1.0, 0.1, 0.05]
        got = _run_sequence(vals, patience=3, d=0.0)
        assert got[3] == (3, True, np.float32(1.0))
        # post-stop epochs change nothing, even on a would-be improvement
        assert got[4] == got[3] and got[5] == got[3]


class TestEndToEnd:
    def _fit(self, d, epochs=30, patience=4):
        cfg = ExperimentConfig.from_dict(dict(
            k_spatial_centers=[9], k_temporal_centers=[4],
            hidden_dims=[16, 8], dropout=0.0, epochs=epochs, lr=5e-3,
            batch_size=64, patience=patience, warmup_epochs=1,
            scheduler="cosine", grad_clip=10.0, regression_type="mean",
            early_stop_min_rel_delta=d))
        rng = np.random.default_rng(0)
        n = 256
        coords = rng.uniform(size=(n, 2)).astype(np.float32)
        t = rng.uniform(size=(n, 1)).astype(np.float32)
        y = (np.sin(3 * coords[:, :1]) + 0.5 * t).astype(np.float32)
        tr = PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                      n_real=n)
        va = PointSet(coords=coords[:64], t=t[:64], y=y[:64],
                      w=np.ones(64, np.float32), n_real=64)
        spec = spec_from_config(cfg)
        params, consts = init_model(jax.random.PRNGKey(3), spec)
        return fit(cfg, spec, params, consts, tr, va, seed=3, epochs_chunk=5)

    def test_aggressive_delta_stops_earlier_history_prefix_identical(self):
        base = self._fit(0.0)
        strict = self._fit(0.5)   # 50% relative improvement required
        assert strict.n_epochs_run < base.n_epochs_run
        k = strict.n_epochs_run
        # identical training dynamics up to the stop (the knob only gates
        # the stop decision, never the update math)
        np.testing.assert_array_equal(strict.history["train_loss"][:k],
                                      base.history["train_loss"][:k])

    def test_zero_delta_preserves_default_path(self):
        """early_stop_min_rel_delta=0.0 (the default) and an explicit 0.0
        produce the same program/history; guards the knob's inert form."""
        a = self._fit(0.0)
        cfg_default = ExperimentConfig.from_dict(dict(k_spatial_centers=[9]))
        assert cfg_default.early_stop_min_rel_delta == 0.0
        b = self._fit(0.0)
        np.testing.assert_array_equal(a.history["train_loss"],
                                      b.history["train_loss"])


def test_fit_tp_refuses_knob():
    from jax.sharding import Mesh

    from st_dadk_tpu.parallel.tensor_parallel import fit_tp
    cfg = ExperimentConfig.from_dict(dict(
        k_spatial_centers=[16], hidden_dims=[16],
        early_stop_min_rel_delta=0.01))
    devices = jax.devices()
    mesh = Mesh(np.array(devices[:2]), ("tp",))
    with pytest.raises(NotImplementedError, match="plateau"):
        fit_tp(cfg, None, None, None, None, None, mesh, seed=0)


def test_carry_has_sig_anchor():
    from st_dadk_tpu.models.st_interp import ModelSpec
    spec = ModelSpec(k_spatial_centers=(9,), k_temporal_centers=(4,),
                     hidden_dims=(8,))
    params, _ = init_model(jax.random.PRNGKey(0), spec)
    c = init_carry(params, jax.random.PRNGKey(1))
    assert "sig_best" in c and not np.isfinite(float(c["sig_best"]))
