"""Mid-training checkpoint/resume: interrupted + resumed training must equal
an uninterrupted run bit-for-bit (the reference can only restart whole
experiments; this checkpoints the loop itself)."""
import jax
import numpy as np

from st_dadk_tpu.config import ExperimentConfig
from st_dadk_tpu.dataio.arrays import PointSet
from st_dadk_tpu.models.st_interp import init_model, spec_from_config
from st_dadk_tpu.train.loop import fit


def _synthetic(n=256, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + 0.5 * t).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32), n_real=n)


def _cfg(epochs):
    return ExperimentConfig.from_dict(dict(
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.1, epochs=epochs, lr=5e-3, batch_size=64, patience=100,
        warmup_epochs=2, scheduler="cosine", grad_clip=10.0,
        regression_type="mean"))


def test_resume_bitwise_equals_uninterrupted(tmp_path):
    cfg = _cfg(12)
    train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(3), spec)

    # uninterrupted
    full = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
               epochs_chunk=4)

    # interrupted after 8 of 12 epochs (session budget) ...
    ckpt = tmp_path / "fit.ckpt.npz"
    partial = fit(cfg, spec, params, consts, train_ps, valid_ps,
                  seed=3, epochs_chunk=4, checkpoint_path=ckpt,
                  session_epochs=8)
    assert ckpt.exists()
    assert partial.n_epochs_run == 8
    # ... then resumed to the full 12 epochs
    resumed = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
                  epochs_chunk=4, checkpoint_path=ckpt, resume=True)

    assert resumed.n_epochs_run == full.n_epochs_run == 12
    assert np.array_equal(resumed.history["train_loss"],
                          full.history["train_loss"])
    assert np.array_equal(resumed.history["val_loss"], full.history["val_loss"])
    for k in ("mlp",):
        a = jax.tree_util.tree_leaves(resumed.params[k])
        b = jax.tree_util.tree_leaves(full.params[k])
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_session_budget_not_a_chunk_multiple(tmp_path):
    """session_epochs smaller than / not aligned to epochs_chunk must be
    honored exactly (regression: the chunk size was clamped to total epochs
    but not to the session budget, overshooting by up to chunk-1 epochs) —
    and the resumed run still equals the uninterrupted one bitwise."""
    cfg = _cfg(12)
    train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(3), spec)
    full = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
               epochs_chunk=4)
    ckpt = tmp_path / "fit.ckpt.npz"
    partial = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
                  epochs_chunk=8, checkpoint_path=ckpt, session_epochs=5)
    assert partial.n_epochs_run == 5
    resumed = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
                  epochs_chunk=8, checkpoint_path=ckpt, resume=True)
    assert resumed.n_epochs_run == 12
    assert np.array_equal(resumed.history["train_loss"],
                          full.history["train_loss"])


def test_session_budget_zero_returns_initial_state():
    cfg = _cfg(8)
    train_ps, valid_ps = _synthetic(128, 0), _synthetic(32, 1)
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    r = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
            epochs_chunk=4, session_epochs=0)
    assert r.n_epochs_run == 0
    assert len(r.history["train_loss"]) == 0
    # zero epochs run => returned params (best EMA) ARE the initial params,
    # bitwise — catches accidental re-init / mutation on the 0-epoch path
    flat_in, _ = jax.tree_util.tree_flatten(params)
    flat_out, _ = jax.tree_util.tree_flatten(r.params)
    assert len(flat_in) == len(flat_out)
    for a, b in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_skips_when_finished(tmp_path):
    cfg = _cfg(8)
    train_ps, valid_ps = _synthetic(128, 0), _synthetic(32, 1)
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(0), spec)
    ckpt = tmp_path / "c.npz"
    r1 = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
             epochs_chunk=4, checkpoint_path=ckpt)
    r2 = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=0,
             epochs_chunk=4, checkpoint_path=ckpt, resume=True)
    assert r2.n_epochs_run == r1.n_epochs_run
    assert np.allclose(r2.history["val_loss"], r1.history["val_loss"])


def _tiny_carry(v: float):
    import jax.numpy as jnp
    return {"key": jax.random.PRNGKey(int(v)),
            "params": {"w": jnp.full((3,), float(v))}}


def _carry_val(carry) -> float:
    return float(np.asarray(carry["params"]["w"])[0])


class TestOrbaxCrashWindows:
    """The Orbax backend replaces checkpoints with a tmp+swap (write
    state.tmp, rename state->state.old, promote tmp, drop old). A crash in
    any window must leave a loadable checkpoint — either the completed new
    save or the previous one — never nothing."""

    def _save(self, path, v, epochs):
        import pytest
        pytest.importorskip("orbax.checkpoint")
        from st_dadk_tpu.train.checkpoint import save_checkpoint
        save_checkpoint(path, _tiny_carry(v), epochs, [])

    def test_overwrite_swaps_cleanly(self, tmp_path):
        from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                                  load_checkpoint)
        ckpt = tmp_path / "ck"
        self._save(ckpt, 1.0, 5)
        self._save(ckpt, 2.0, 10)
        assert (ckpt / "state").exists()
        assert not (ckpt / "state.tmp").exists()
        assert not (ckpt / "state.old").exists()
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 2.0 and epochs == 10
        assert checkpoint_exists(ckpt)

    def test_window_state_plus_tmp_prefers_completed(self, tmp_path):
        """Crash after writing state.tmp but before any rename: `state` is
        still the last COMPLETED save and must win over the newer tmp."""
        import shutil
        from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                                  load_checkpoint)
        a, b, ckpt = tmp_path / "a", tmp_path / "b", tmp_path / "ck"
        self._save(a, 1.0, 5)
        self._save(b, 2.0, 10)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / "state"))
        shutil.move(str(b / "state"), str(ckpt / "state.tmp"))
        assert checkpoint_exists(ckpt)
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 1.0 and epochs == 5

    def test_window_tmp_plus_old_prefers_tmp(self, tmp_path):
        """Crash between demoting the old state and promoting tmp: tmp is
        fully written (save+wait completed before any rename) and newer."""
        import shutil
        from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                                  load_checkpoint)
        a, b, ckpt = tmp_path / "a", tmp_path / "b", tmp_path / "ck"
        self._save(a, 1.0, 5)
        self._save(b, 2.0, 10)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / "state.old"))
        shutil.move(str(b / "state"), str(ckpt / "state.tmp"))
        assert checkpoint_exists(ckpt)
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 2.0 and epochs == 10

    def test_window_state_plus_old_prefers_state(self, tmp_path):
        """Crash after promoting tmp but before dropping the old copy."""
        import shutil
        from st_dadk_tpu.train.checkpoint import load_checkpoint
        a, b, ckpt = tmp_path / "a", tmp_path / "b", tmp_path / "ck"
        self._save(a, 1.0, 5)
        self._save(b, 2.0, 10)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / "state.old"))
        shutil.move(str(b / "state"), str(ckpt / "state"))
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 2.0 and epochs == 10

    def test_save_over_crash_residue_recovers(self, tmp_path):
        """A save on top of any crash residue must converge back to the
        clean single-`state` layout."""
        import shutil
        from st_dadk_tpu.train.checkpoint import load_checkpoint
        a, ckpt = tmp_path / "a", tmp_path / "ck"
        self._save(a, 1.0, 5)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / "state.tmp"))
        self._save(ckpt, 3.0, 15)
        assert (ckpt / "state").exists()
        assert not (ckpt / "state.tmp").exists()
        assert not (ckpt / "state.old").exists()
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 3.0 and epochs == 15

    def test_bare_orbax_checkpoint_dir_loads(self, tmp_path):
        """A path that IS an Orbax checkpoint (the user pointed at
        <ckpt>/state directly) must load, so checkpoint_exists() == True
        always implies load_checkpoint() succeeds (regression: exists said
        True via _CHECKPOINT_METADATA but load raised FileNotFoundError)."""
        import shutil
        from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                                  load_checkpoint)
        a, ckpt = tmp_path / "a", tmp_path / "bare"
        self._save(a, 4.0, 7)
        shutil.move(str(a / "state"), str(ckpt))
        assert (ckpt / "_CHECKPOINT_METADATA").exists()
        assert checkpoint_exists(ckpt)
        carry, epochs, _ = load_checkpoint(ckpt)
        assert _carry_val(carry) == 4.0 and epochs == 7

    def test_empty_dir_raises_and_not_exists(self, tmp_path):
        import pytest
        pytest.importorskip("orbax.checkpoint")
        from st_dadk_tpu.train.checkpoint import (checkpoint_exists,
                                                  load_checkpoint)
        ckpt = tmp_path / "ck"
        ckpt.mkdir()
        assert not checkpoint_exists(ckpt)
        with pytest.raises(FileNotFoundError):
            load_checkpoint(ckpt)


def test_orbax_backend_resume_bitwise(tmp_path):
    """A non-.npz checkpoint path selects the Orbax backend; interrupted +
    resumed training must still equal the uninterrupted run bit-for-bit."""
    import pytest
    pytest.importorskip("orbax.checkpoint")
    cfg = _cfg(12)
    train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
    spec = spec_from_config(cfg)
    params, consts = init_model(jax.random.PRNGKey(3), spec)

    full = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
               epochs_chunk=4)

    ckpt = tmp_path / "orbax_ckpt"          # directory -> Orbax
    partial = fit(cfg, spec, params, consts, train_ps, valid_ps,
                  seed=3, epochs_chunk=4, checkpoint_path=ckpt,
                  session_epochs=8)
    assert (ckpt / "state").exists()
    assert partial.n_epochs_run == 8
    resumed = fit(cfg, spec, params, consts, train_ps, valid_ps, seed=3,
                  epochs_chunk=4, checkpoint_path=ckpt, resume=True)

    assert resumed.n_epochs_run == full.n_epochs_run == 12
    assert np.array_equal(resumed.history["train_loss"],
                          full.history["train_loss"])
    a = jax.tree_util.tree_leaves(resumed.params["mlp"])
    b = jax.tree_util.tree_leaves(full.params["mlp"])
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
