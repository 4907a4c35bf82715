"""Data-adaptive initializer tests (JAX GMM-EM / balanced k-means /
random-site vs reference semantics)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu.ops.basis import uniform_bandwidth_for
from st_dadk_tpu.ops.init_centers import (balanced_kmeans, gmm_spherical,
                                          init_spatial_centers,
                                          kmeans_plus_plus)


def _two_clusters(n=400, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal([0.25, 0.25], 0.05, size=(n // 2, 2))
    b = rng.normal([0.75, 0.75], 0.05, size=(n // 2, 2))
    return np.concatenate([a, b]).astype(np.float32)


class TestKmeansPP:
    def test_spread(self):
        X = jnp.asarray(_two_clusters())
        centers = np.asarray(kmeans_plus_plus(jax.random.PRNGKey(0), X, 2))
        # one seed per cluster (they are 0.7 apart, sigma 0.05)
        d = np.linalg.norm(centers[0] - centers[1])
        assert d > 0.3


class TestGMM:
    def test_recovers_two_clusters(self):
        X = jnp.asarray(_two_clusters())
        means, sigmas = gmm_spherical(jax.random.PRNGKey(1), X, 2,
                                      max_iter=50, n_init=3)
        means = np.asarray(means)
        sigmas = np.asarray(sigmas)
        got = sorted(means.sum(axis=1))
        assert abs(got[0] - 0.5) < 0.1 and abs(got[1] - 1.5) < 0.1
        assert np.all(sigmas > 0.02) and np.all(sigmas < 0.12)

    def test_finite_on_degenerate_data(self):
        # all points identical — variance clamps at reg_covar, no NaN
        X = jnp.ones((100, 2)) * 0.5
        means, sigmas = gmm_spherical(jax.random.PRNGKey(0), X, 3,
                                      max_iter=20, n_init=1)
        assert np.isfinite(np.asarray(means)).all()
        assert np.isfinite(np.asarray(sigmas)).all()

    def test_bf16_em_close_to_f32(self):
        # em_dtype='bfloat16' stores the (n,k) EM tensors in bf16 (a
        # memory-traffic optimization); outputs must be f32, finite, and land
        # on the same cluster structure as the exact program
        X = jnp.asarray(_two_clusters(800, 3))
        m32, s32 = gmm_spherical(jax.random.PRNGKey(5), X, 2, max_iter=50)
        m16, s16 = gmm_spherical(jax.random.PRNGKey(5), X, 2, max_iter=50,
                                 em_dtype="bfloat16")
        assert m16.dtype == jnp.float32 and s16.dtype == jnp.float32
        assert np.isfinite(np.asarray(m16)).all()
        # same two cluster centers up to bf16-induced jitter + permutation
        got32 = np.sort(np.asarray(m32).sum(1))
        got16 = np.sort(np.asarray(m16).sum(1))
        np.testing.assert_allclose(got16, got32, atol=0.05)
        np.testing.assert_allclose(np.sort(np.asarray(s16)),
                                   np.sort(np.asarray(s32)), rtol=0.1)

    def test_bf16_em_weighted_padding_exact(self):
        # zero-weight padding rows must stay exactly inert in bf16 too
        X = np.asarray(_two_clusters(300, 4))
        Xp = np.concatenate([X, np.full((50, 2), 7.7, np.float32)])
        w = np.concatenate([np.ones(300, np.float32),
                            np.zeros(50, np.float32)])
        m_pad, _ = gmm_spherical(jax.random.PRNGKey(3), jnp.asarray(Xp), 2,
                                 max_iter=30, w=jnp.asarray(w),
                                 em_dtype="bfloat16")
        got = np.sort(np.asarray(m_pad).sum(1))
        assert abs(got[0] - 0.5) < 0.15 and abs(got[1] - 1.5) < 0.15


class TestBalancedKmeans:
    def test_balance(self):
        X = jnp.asarray(_two_clusters(600, 2))
        centers = np.asarray(balanced_kmeans(jax.random.PRNGKey(2), X, 4,
                                             max_iter=40))
        assert np.isfinite(centers).all()
        # occupancy is roughly balanced under plain nearest-center assignment
        d = ((np.asarray(X)[:, None] - centers[None]) ** 2).sum(-1)
        counts = np.bincount(d.argmin(1), minlength=4)
        assert counts.min() > 0.4 * 600 / 4
        assert counts.max() < 2.2 * 600 / 4


class TestDispatcher:
    def test_uniform(self):
        c, bw = init_spatial_centers("uniform", [25, 81])
        assert c.shape == (106, 2) and bw.shape == (106,)

    def test_gmm_bandwidth_floor(self):
        X = _two_clusters()
        c, bw = init_spatial_centers("gmm", [25], X,
                                     key=jax.random.PRNGKey(0))
        # bandwidth = 4.23*2.5*sigma clipped below 0.25 x uniform bw
        assert bw.min() >= 0.25 * uniform_bandwidth_for(25) - 1e-6
        assert c.shape == (25, 2)

    def test_random_site_draws_data_points(self):
        np.random.seed(0)
        X = _two_clusters()
        c, bw = init_spatial_centers("random_site", [9], X)
        # every center is an actual data coordinate
        for row in c:
            assert np.any(np.all(np.isclose(X, row, atol=1e-7), axis=1))
        assert np.all(bw > 0)

    def test_kmeans_balanced_shapes(self):
        np.random.seed(0)
        X = _two_clusters()
        c, bw = init_spatial_centers("kmeans_balanced", [9, 16], X,
                                     key=jax.random.PRNGKey(3))
        assert c.shape == (25, 2) and bw.shape == (25,)
        assert np.all(bw > 0)

    def test_requires_coords(self):
        with pytest.raises(ValueError):
            init_spatial_centers("gmm", [9], None)
        with pytest.raises(ValueError):
            init_spatial_centers("voronoi", [9], _two_clusters())


class TestCrossEngineInitEquality:
    """Sequential engine and batch engine must produce IDENTICAL
    data-adaptive inits for the same seed (round-1 review: the engines used
    different RNG streams for subsampling/site draws)."""

    def _states_and_coords(self, sizes, monkeypatch, cap=500):
        import st_dadk_tpu.ops.init_centers as ic
        monkeypatch.setattr(ic, "MAX_INIT_SAMPLES", cap)
        states, coords = [], []
        for i, n in enumerate(sizes):
            np.random.seed(1000 + i)
            np.random.uniform(size=7 + i)      # arbitrary prior stream use
            states.append(np.random.get_state())
            coords.append(np.random.default_rng(50 + i)
                          .uniform(size=(n, 2)).astype(np.float32))
        return states, coords

    def _run_both(self, method, ks, states, coords):
        from st_dadk_tpu.ops.init_centers import (init_spatial_centers,
                                                  init_spatial_centers_batch)
        seq = []
        for i, (st, tc) in enumerate(zip(states, coords)):
            np.random.set_state(st)
            seq.append(init_spatial_centers(method, ks, tc,
                                            key=jax.random.PRNGKey(100 + i)))
        keys = jnp.stack([jax.random.PRNGKey(100 + i)
                          for i in range(len(coords))])
        bat = init_spatial_centers_batch(method, ks, coords, keys,
                                         rng_states=states)
        return seq, bat

    def test_random_site_bit_equal(self, monkeypatch):
        states, coords = self._states_and_coords([700, 600], monkeypatch)
        seq, bat = self._run_both("random_site", [9, 16], states, coords)
        for (c1, b1), (c2, b2) in zip(seq, bat):
            np.testing.assert_array_equal(c2, c1)
            np.testing.assert_array_equal(b2, b1)

    def test_gmm_equal_sizes(self, monkeypatch):
        # both lanes subsample to the cap -> identical X per lane; vmapped
        # EM vs single EM may differ only in f32 fusion order
        states, coords = self._states_and_coords([700, 650], monkeypatch)
        seq, bat = self._run_both("gmm", [9], states, coords)
        for (c1, b1), (c2, b2) in zip(seq, bat):
            np.testing.assert_allclose(c2, c1, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(b2, b1, rtol=1e-4, atol=1e-5)

    def test_weighted_padding_invariance(self):
        """Zero-weight padding rows must not change the weighted EM / OT
        results at all — the property the unequal-size stacked path relies
        on."""
        from st_dadk_tpu.ops.init_centers import balanced_kmeans
        X = jnp.asarray(_two_clusters(400, 5))
        w = jnp.ones((400,))
        X_pad = jnp.concatenate([X, jnp.full((100, 2), 7.7)], axis=0)
        w_pad = jnp.concatenate([w, jnp.zeros((100,))])

        m1, s1 = gmm_spherical(jax.random.PRNGKey(3), X, 4, w=w)
        m2, s2 = gmm_spherical(jax.random.PRNGKey(3), X_pad, 4, w=w_pad)
        np.testing.assert_allclose(np.asarray(m2), np.asarray(m1),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1),
                                   rtol=1e-4, atol=1e-5)

        c1 = balanced_kmeans(jax.random.PRNGKey(4), X, 4, w=w)
        c2 = balanced_kmeans(jax.random.PRNGKey(4), X_pad, 4, w=w_pad)
        np.testing.assert_allclose(np.asarray(c2), np.asarray(c1),
                                   rtol=1e-3, atol=1e-4)

    def test_balanced_kmeans_equal_sizes(self, monkeypatch):
        states, coords = self._states_and_coords([700, 650], monkeypatch)
        seq, bat = self._run_both("kmeans_balanced", [9], states, coords)
        for (c1, _), (c2, _) in zip(seq, bat):
            np.testing.assert_allclose(c2, c1, rtol=1e-4, atol=1e-5)


class TestKActiveMasking:
    """k_active-padded programs must reproduce the unpadded per-resolution
    programs in their active prefix — the property that lets a
    multi-resolution init run as ONE merged vmapped program
    (_batched_gmm_multi/_batched_bkm_multi)."""

    def test_gmm_padded_matches_unpadded(self):
        X = jnp.asarray(_two_clusters(500, 9))
        for k in (4, 9):
            m1, s1 = gmm_spherical(jax.random.PRNGKey(7), X, k)
            m2, s2 = gmm_spherical(jax.random.PRNGKey(7), X, 16,
                                   k_active=jnp.asarray(k, jnp.int32))
            np.testing.assert_allclose(np.asarray(m2)[:k], np.asarray(m1),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(np.asarray(s2)[:k], np.asarray(s1),
                                       rtol=1e-4, atol=1e-5)

    def test_balanced_kmeans_padded_matches_unpadded(self):
        from st_dadk_tpu.ops.init_centers import balanced_kmeans
        X = jnp.asarray(_two_clusters(500, 11))
        for k in (4, 8):
            c1 = balanced_kmeans(jax.random.PRNGKey(8), X, k)
            c2 = balanced_kmeans(jax.random.PRNGKey(8), X, 12,
                                 k_active=jnp.asarray(k, jnp.int32))
            np.testing.assert_allclose(np.asarray(c2)[:k], np.asarray(c1),
                                       rtol=1e-3, atol=1e-4)

    def test_kmeans_pp_padded_prefix_matches(self):
        from st_dadk_tpu.ops.init_centers import kmeans_plus_plus
        X = jnp.asarray(_two_clusters(300, 3))
        c1 = kmeans_plus_plus(jax.random.PRNGKey(9), X, 5)
        c2 = kmeans_plus_plus(jax.random.PRNGKey(9), X, 11,
                              k_active=jnp.asarray(5, jnp.int32))
        np.testing.assert_array_equal(np.asarray(c2)[:5], np.asarray(c1))


class TestInitCostKnobs:
    """Opt-in cost knobs (cfg.extra init_gmm_n_init / init_subsample): the
    overrides must produce valid inits, honor the cap, and keep the
    cross-engine (sequential vs batched) equality contract when both
    engines get the same knob values."""

    def test_n_init_1_valid_and_differs(self, monkeypatch):
        import st_dadk_tpu.ops.init_centers as ic
        X = _two_clusters(600, 1)
        # Record the n_init each call actually receives: the similarity
        # assertion below would also pass if the knob were silently
        # dropped, so forwarding must be asserted directly.
        seen = []
        real = ic.gmm_spherical

        def recording(key, X, k, **kw):
            seen.append(kw.get("n_init"))
            return real(key, X, k, **kw)

        monkeypatch.setattr(ic, "gmm_spherical", recording)
        c3, b3 = init_spatial_centers("gmm", [9], X,
                                      key=jax.random.PRNGKey(5))
        assert seen == [3]
        c1, b1 = init_spatial_centers("gmm", [9], X,
                                      key=jax.random.PRNGKey(5),
                                      gmm_n_init=1)
        assert seen == [3, 1]
        assert c1.shape == (9, 2) and np.all(np.isfinite(c1))
        assert np.all(b1 > 0)
        # n_init=1 keeps the FIRST restart instead of the best of 3; on a
        # well-separated mixture both land on the clusters
        assert np.abs(np.sort(c1[:, 0]) - np.sort(c3[:, 0])).mean() < 0.2

    def test_subsample_cap_is_honored(self):
        from st_dadk_tpu.ops.init_centers import _subsample
        X = _two_clusters(5000, 2)
        np.random.seed(0)
        sub = _subsample(X, 512)
        assert sub.shape == (512, 2)
        np.random.seed(0)
        assert _subsample(X).shape == X.shape  # default cap 10k > n

    def test_subsample_knob_end_to_end(self):
        X = _two_clusters(4000, 3)
        np.random.seed(7)
        c, bw = init_spatial_centers("gmm", [4], X,
                                     key=jax.random.PRNGKey(7),
                                     subsample=256)
        assert c.shape == (4, 2) and np.all(np.isfinite(c))
        assert np.all(bw > 0)

    def test_cross_engine_equality_with_knobs(self):
        from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
        X = _two_clusters(3000, 4)
        lanes = [X, _two_clusters(3000, 5)]
        keys = jax.random.split(jax.random.PRNGKey(11), 2)
        seq, states = [], []
        for i in range(2):
            np.random.seed(100 + i)
            states.append(np.random.get_state())
            seq.append(init_spatial_centers("gmm", [9], lanes[i],
                                            key=keys[i], gmm_n_init=1,
                                            subsample=512))
        batched = init_spatial_centers_batch("gmm", [9], lanes, keys,
                                             rng_states=states,
                                             gmm_n_init=1, subsample=512)
        for i in range(2):
            np.testing.assert_allclose(batched[i][0], seq[i][0],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(batched[i][1], seq[i][1],
                                       rtol=1e-5, atol=1e-6)


class TestHostPathKnobForwarding:
    def test_kmeans_exact_batch_honors_subsample(self):
        """The batched init's host path (random_site/kmeans_exact) must
        forward the opt-in knobs — regression: engine='vmap' silently ran
        kmeans_exact on the default 10k cap while sequential honored
        init_subsample, breaking cross-engine init equality."""
        from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
        X = _two_clusters(3000, 9)
        np.random.seed(31)
        state = np.random.get_state()
        key = jax.random.PRNGKey(31)
        np.random.set_state(state)
        c_seq, b_seq = init_spatial_centers("kmeans_exact", [4], X, key=key,
                                            subsample=256)
        out = init_spatial_centers_batch("kmeans_exact", [4], [X],
                                         key[None], rng_states=[state],
                                         subsample=256)
        np.testing.assert_array_equal(out[0][0], c_seq)
        np.testing.assert_array_equal(out[0][1], b_seq)


class TestSeedingBitEquality:
    """The weighted k-means++ program with 0/1 padding weights must make the
    SAME draws as the unweighted program on the real prefix — this closes
    the last cross-engine RNG asymmetry: a lane stacked into an
    unequal-size padded batch now seeds bit-identically to its own
    standalone (unweighted) fit."""

    def test_kmeans_pp_weighted_ones_equals_unweighted(self):
        X = jnp.asarray(_two_clusters(400, 6))
        for k in (4, 9):
            c_un = kmeans_plus_plus(jax.random.PRNGKey(13), X, k)
            c_w = kmeans_plus_plus(jax.random.PRNGKey(13), X, k,
                                   w=jnp.ones((400,)))
            np.testing.assert_array_equal(np.asarray(c_w), np.asarray(c_un))

    def test_kmeans_pp_padded_equals_standalone(self):
        X = jnp.asarray(_two_clusters(400, 6))
        X_pad = jnp.concatenate([X, jnp.full((88, 2), 3.3)], axis=0)
        w_pad = jnp.concatenate([jnp.ones((400,)), jnp.zeros((88,))])
        c_un = kmeans_plus_plus(jax.random.PRNGKey(14), X, 9)
        c_pad = kmeans_plus_plus(jax.random.PRNGKey(14), X_pad, 9, w=w_pad)
        np.testing.assert_array_equal(np.asarray(c_pad), np.asarray(c_un))

    def test_gmm_padded_equals_standalone_unweighted(self):
        X = jnp.asarray(_two_clusters(500, 8))
        X_pad = jnp.concatenate([X, jnp.full((60, 2), 9.9)], axis=0)
        w_pad = jnp.concatenate([jnp.ones((500,)), jnp.zeros((60,))])
        m1, s1 = gmm_spherical(jax.random.PRNGKey(15), X, 4)
        m2, s2 = gmm_spherical(jax.random.PRNGKey(15), X_pad, 4, w=w_pad)
        np.testing.assert_allclose(np.asarray(m2), np.asarray(m1),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1),
                                   rtol=1e-5, atol=1e-6)


class TestDeviceBandwidths:
    """_nn_bandwidths_jnp (device path used by device_out=True inits) must
    match the host _nn_bandwidths exactly — regression for the eye*inf
    diagonal mask that turned every off-diagonal entry into 0*inf = NaN."""

    def test_matches_host_path(self):
        from st_dadk_tpu.ops.init_centers import (_nn_bandwidths,
                                                  _nn_bandwidths_jnp)
        c = np.random.default_rng(0).uniform(size=(3, 9, 2)).astype(
            np.float32)
        dev = np.asarray(_nn_bandwidths_jnp(jnp.asarray(c), 9))
        host = np.stack([_nn_bandwidths(c[i]) for i in range(3)])
        assert np.isfinite(dev).all()
        np.testing.assert_allclose(dev, host, rtol=1e-5)

    def test_device_out_balanced_init_finite(self):
        from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
        lanes = [_two_clusters(500, 1), _two_clusters(500, 2)]
        keys = jax.random.split(jax.random.PRNGKey(7), 2)
        centers_b, bw_b = init_spatial_centers_batch(
            "kmeans_balanced", [4, 9], lanes, keys, device_out=True)
        assert np.isfinite(np.asarray(centers_b)).all()
        assert np.isfinite(np.asarray(bw_b)).all()
        assert (np.asarray(bw_b) > 0).all()


class TestSeedRounds:
    """Opt-in low-depth seeding (cfg.extra init_seed_rounds): the R-round
    batched k-means++ variant must keep the padding bit-equality contract,
    mask k_active correctly, seed well enough for EM to recover structure,
    and stay cross-engine equal when both engines get the knob."""

    def test_rounds_shape_and_spread(self):
        from st_dadk_tpu.ops.init_centers import kmeans_plus_plus_rounds
        X = jnp.asarray(_two_clusters(400, 0))
        c = np.asarray(kmeans_plus_plus_rounds(jax.random.PRNGKey(0), X, 9,
                                               rounds=4))
        assert c.shape == (9, 2) and np.isfinite(c).all()
        # every seed is an actual data point
        d = ((c[:, None] - np.asarray(X)[None]) ** 2).sum(-1).min(1)
        assert d.max() == 0.0
        # both clusters get at least one seed (centroids 0.7 apart)
        sums = c.sum(1)
        assert sums.min() < 1.0 < sums.max()

    def test_rounds_padded_equals_standalone(self):
        from st_dadk_tpu.ops.init_centers import kmeans_plus_plus_rounds
        X = jnp.asarray(_two_clusters(400, 6))
        X_pad = jnp.concatenate([X, jnp.full((88, 2), 3.3)], axis=0)
        w_pad = jnp.concatenate([jnp.ones((400,)), jnp.zeros((88,))])
        c_un = kmeans_plus_plus_rounds(jax.random.PRNGKey(14), X, 9,
                                       rounds=4)
        c_pad = kmeans_plus_plus_rounds(jax.random.PRNGKey(14), X_pad, 9,
                                        rounds=4, w=w_pad)
        np.testing.assert_array_equal(np.asarray(c_pad), np.asarray(c_un))

    def test_rounds_k_active_leading_rows_match_full(self):
        # with one candidate per round, rows with global index < k_active
        # see only live predecessors, so they match the unmasked program
        from st_dadk_tpu.ops.init_centers import kmeans_plus_plus_rounds
        X = jnp.asarray(_two_clusters(300, 7))
        full = kmeans_plus_plus_rounds(jax.random.PRNGKey(3), X, 8, rounds=7)
        masked = kmeans_plus_plus_rounds(jax.random.PRNGKey(3), X, 8,
                                         rounds=7,
                                         k_active=jnp.asarray(3, jnp.int32))
        np.testing.assert_array_equal(np.asarray(masked)[:3],
                                      np.asarray(full)[:3])

    def test_gmm_seed_rounds_recovers_clusters(self):
        X = jnp.asarray(_two_clusters(800, 9))
        means, sigmas = gmm_spherical(jax.random.PRNGKey(2), X, 2,
                                      max_iter=50, seed_rounds=4)
        got = sorted(np.asarray(means).sum(axis=1))
        assert abs(got[0] - 0.5) < 0.1 and abs(got[1] - 1.5) < 0.1
        assert np.isfinite(np.asarray(sigmas)).all()

    def test_balanced_kmeans_seed_rounds(self):
        X = jnp.asarray(_two_clusters(600, 10))
        centers = np.asarray(balanced_kmeans(jax.random.PRNGKey(4), X, 4,
                                             max_iter=30, seed_rounds=3))
        assert np.isfinite(centers).all()
        # rounds-seeding may start near-duplicate seeds (the documented
        # trade-off), so don't demand near-equal nearest-center occupancy —
        # just that every center ends up used and inside the data range
        d = ((np.asarray(X)[:, None] - centers[None]) ** 2).sum(-1)
        counts = np.bincount(d.argmin(1), minlength=4)
        assert counts.min() > 0
        lo, hi = np.asarray(X).min() - 0.1, np.asarray(X).max() + 0.1
        assert (centers >= lo).all() and (centers <= hi).all()

    def test_k1_degenerate(self):
        from st_dadk_tpu.ops.init_centers import kmeans_plus_plus_rounds
        X = jnp.asarray(_two_clusters(100, 11))
        c = np.asarray(kmeans_plus_plus_rounds(jax.random.PRNGKey(5), X, 1,
                                               rounds=8))
        assert c.shape == (1, 2) and np.isfinite(c).all()

    def test_cross_engine_equality_with_seed_rounds(self):
        from st_dadk_tpu.ops.init_centers import init_spatial_centers_batch
        X = _two_clusters(3000, 12)
        lanes = [X, _two_clusters(3000, 13)]
        keys = jax.random.split(jax.random.PRNGKey(21), 2)
        seq, states = [], []
        for i in range(2):
            np.random.seed(200 + i)
            states.append(np.random.get_state())
            seq.append(init_spatial_centers("gmm", [9], lanes[i],
                                            key=keys[i], gmm_n_init=1,
                                            subsample=512, seed_rounds=4))
        batched = init_spatial_centers_batch("gmm", [9], lanes, keys,
                                             rng_states=states,
                                             gmm_n_init=1, subsample=512,
                                             seed_rounds=4)
        for i in range(2):
            np.testing.assert_allclose(batched[i][0], seq[i][0],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(batched[i][1], seq[i][1],
                                       rtol=1e-5, atol=1e-6)
