"""Exact size-constrained k-means: auction solver optimality + partition
balance + dispatcher integration (the opt-in kmeans_exact init,
ref stnf/models/st_interp.py:340-431)."""
import itertools

import numpy as np
import pytest

from st_dadk_tpu.ops.kmeans_exact import (auction_assign_balanced,
                                          balanced_caps,
                                          constrained_assignment,
                                          kmeans_constrained)


class TestAuctionExactness:
    def test_matches_brute_force(self):
        rng = np.random.default_rng(1)
        for trial in range(25):
            n, m = 9, 3
            cost = rng.integers(0, 25, size=(n, m)).astype(np.float64)
            caps = balanced_caps(n, m)
            col = auction_assign_balanced(cost, caps)
            got = cost[np.arange(n), col].sum()
            best = np.inf
            for assign in itertools.product(range(m), repeat=n):
                a = np.asarray(assign)
                if np.all(np.bincount(a, minlength=m) == caps):
                    best = min(best, cost[np.arange(n), a].sum())
            assert got == best, (trial, got, best)
            assert np.array_equal(np.bincount(col, minlength=m), caps)

    def test_matches_lp_midsize(self):
        """Against scipy HiGHS LP (the transportation LP has an integral
        optimum, so the LP value equals the exact MCF value)."""
        from scipy import sparse
        from scipy.optimize import linprog

        rng = np.random.default_rng(0)
        n, k = 200, 6
        X = rng.uniform(size=(n, 2))
        C = rng.uniform(size=(k, 2))
        cost = ((X[:, None] - C[None]) ** 2).sum(-1)
        caps = balanced_caps(n, k)
        col = constrained_assignment(cost, caps)
        my = cost[np.arange(n), col].sum()

        nv = n * k
        A_eq = sparse.csr_matrix(
            (np.ones(nv), (np.repeat(np.arange(n), k), np.arange(nv))),
            shape=(n, nv))
        A_col = sparse.csr_matrix(
            (np.ones(nv), (np.tile(np.arange(k), n), np.arange(nv))),
            shape=(k, nv))
        res = linprog(cost.ravel(), A_eq=sparse.vstack([A_eq, A_col]),
                      b_eq=np.concatenate([np.ones(n), caps]),
                      bounds=(0, None), method="highs")
        assert res.status == 0
        # Feasibility first: without this, an unconstrained argmin (cost
        # <= LP optimum) would pass the one-sided bound below.
        assert np.array_equal(np.bincount(col, minlength=k), caps)
        # Any cap-feasible assignment costs >= the LP optimum, so with
        # feasibility asserted this one-sided bound IS the optimality
        # check. Integer-scaled costs quantize at 1e-7; allow that slack.
        assert my <= res.fun + n * 1e-7, (my, res.fun)


class TestKmeansConstrained:
    def test_exact_equal_sizes(self):
        rng = np.random.default_rng(3)
        X = rng.uniform(size=(500, 2))
        k = 7
        centers, labels = kmeans_constrained(X, k, n_init=2, max_iter=15)
        sizes = np.bincount(labels, minlength=k)
        q, r = divmod(500, k)
        assert sizes.min() == q and sizes.max() == q + 1
        assert (sizes == q + 1).sum() == r
        assert np.isfinite(centers).all()
        # centers inside the data's bounding box
        assert centers.min() >= X.min() - 1e-9
        assert centers.max() <= X.max() + 1e-9

    def test_deterministic(self):
        rng = np.random.default_rng(4)
        X = rng.uniform(size=(300, 2))
        c1, l1 = kmeans_constrained(X, 5, n_init=1, max_iter=10)
        c2, l2 = kmeans_constrained(X, 5, n_init=1, max_iter=10)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_allclose(c1, c2)

    def test_better_than_random_partition(self):
        """The optimized balanced partition should beat a random balanced
        partition's inertia by a wide margin."""
        rng = np.random.default_rng(5)
        X = np.concatenate([rng.normal([0.2, 0.2], 0.05, (150, 2)),
                            rng.normal([0.8, 0.8], 0.05, (150, 2))])
        centers, labels = kmeans_constrained(X, 2, n_init=1, max_iter=10)
        inertia = ((X - centers[labels]) ** 2).sum()
        perm = rng.permutation(300)
        rand_labels = np.zeros(300, np.int64)
        rand_labels[perm[150:]] = 1
        rand_centers = np.stack([X[rand_labels == j].mean(0) for j in (0, 1)])
        rand_inertia = ((X - rand_centers[rand_labels]) ** 2).sum()
        assert inertia < 0.2 * rand_inertia


class TestDedupTransportPath:
    """Duplicate-site fast path: a transportation LP on unique points must
    give the same optimal cost as the point-level auction (duplicates have
    identical cost rows), at a fraction of the work."""

    def test_matches_pointlevel_on_duplicates(self):
        from st_dadk_tpu.ops.kmeans_exact import transport_assign
        rng = np.random.default_rng(11)
        sites = rng.uniform(size=(20, 2))
        X = np.repeat(sites, 15, axis=0)            # 300 points, 20 unique
        k = 6
        c_fast, l_fast = kmeans_constrained(X, k, n_init=1, max_iter=10)
        sizes = np.bincount(l_fast, minlength=k)
        q, r = divmod(len(X), k)
        assert sizes.min() == q and sizes.max() == q + (1 if r else 0)
        # one assignment round at FIXED centers: the transportation plan on
        # unique sites must equal the point-level auction's optimal cost
        centers = rng.uniform(size=(k, 2))
        cost = ((X[:, None] - centers[None]) ** 2).sum(-1)
        caps = balanced_caps(len(X), k)
        col = constrained_assignment(cost, caps)
        point_cost = cost[np.arange(len(X)), col].sum()
        cost_u = ((sites[:, None] - centers[None]) ** 2).sum(-1)
        flows, _ = transport_assign(
            cost_u, np.full(20, 15, np.int64), caps)
        fast_cost = float((flows * cost_u).sum())
        assert abs(fast_cost - point_cost) <= 1e-6 * max(point_cost, 1.0)

    def test_transport_assign_integral_balanced(self):
        from st_dadk_tpu.ops.kmeans_exact import transport_assign
        rng = np.random.default_rng(12)
        u, k = 30, 7
        cost_u = rng.uniform(size=(u, k))
        supplies = rng.integers(1, 9, size=u)
        caps = balanced_caps(int(supplies.sum()), k)
        flows, _ = transport_assign(cost_u, supplies, caps)
        assert flows.min() >= 0
        np.testing.assert_array_equal(flows.sum(axis=1), supplies)
        np.testing.assert_array_equal(flows.sum(axis=0), caps)

    def test_column_generation_matches_full_lp(self):
        """Instances past the 16384-arc threshold route through column
        generation; its optimality certificate (reduced costs under the
        restricted LP's duals) must reproduce the FULL LP's optimal cost.
        Regression for the negated-duals bug that silently terminated the
        loop on garbage reduced costs (15-25% cost gaps on clustered
        instances)."""
        from st_dadk_tpu.ops.kmeans_exact import (_solve_restricted,
                                                  transport_assign)
        rng = np.random.default_rng(21)
        u, k = 220, 90                              # 19800 arcs > 16384
        # clustered geometry (the adversarial case for a cheap-arcs-only
        # restriction): sites and centers in two blobs
        sites = np.concatenate([rng.normal(0, .1, (u // 2, 2)),
                                rng.normal(1, .1, (u - u // 2, 2))])
        centers = np.concatenate([rng.normal(0, .3, (k // 2, 2)),
                                  rng.normal(1, .3, (k - k // 2, 2))])
        cost_u = ((sites[:, None] - centers[None]) ** 2).sum(-1)
        supplies = rng.integers(1, 6, size=u)
        caps = balanced_caps(int(supplies.sum()), k)
        flows, _ = transport_assign(cost_u, supplies, caps, arcs_per_row=8)
        np.testing.assert_array_equal(flows.sum(axis=1), supplies)
        np.testing.assert_array_equal(flows.sum(axis=0), caps)
        rows = np.repeat(np.arange(u), k)
        cols = np.tile(np.arange(k), u)
        full_flows, y, z = _solve_restricted(cost_u, supplies, caps,
                                             rows, cols)
        opt = float((full_flows * cost_u).sum())
        got = float((flows * cost_u).sum())
        assert abs(got - opt) <= 1e-7 * max(opt, 1.0), (got, opt)
        # and the duals sign itself: basic arcs have zero reduced cost
        red = cost_u - y[:, None] - z[None, :]
        assert np.abs(red[full_flows > 0]).max() < 1e-6
        assert red.min() > -1e-6

    def test_native_simplex_matches_lp(self, native_libs):
        """Native network simplex (native/transport.cpp): optimal cost must
        equal the exact LP's on random instances, cold AND warm-started
        across perturbed costs (the Lloyd-iteration usage pattern)."""
        import pytest
        from st_dadk_tpu.ops.kmeans_exact import (transport_assign,
                                                  transport_assign_native)
        rng = np.random.default_rng(13)
        u, k = 40, 9
        supplies = rng.integers(1, 12, size=u)
        caps = balanced_caps(int(supplies.sum()), k)
        cost_u = rng.uniform(size=(u, k))
        out = transport_assign_native(cost_u, supplies, caps)
        if out is None:
            pytest.skip("libstdadk_transport.so not built")
        flows, state = out
        assert flows.min() >= 0
        np.testing.assert_array_equal(flows.sum(axis=1), supplies)
        np.testing.assert_array_equal(flows.sum(axis=0), caps)
        ref_flows, _ = transport_assign(cost_u, supplies, caps)
        np.testing.assert_allclose(float((flows * cost_u).sum()),
                                   float((ref_flows * cost_u).sum()),
                                   rtol=1e-9)
        # warm starts: same supplies/caps, drifting costs (centers moving)
        for it in range(5):
            cost_u = np.abs(cost_u + 0.1 * rng.standard_normal((u, k)))
            flows, state = transport_assign_native(cost_u, supplies, caps,
                                                   state=state)
            np.testing.assert_array_equal(flows.sum(axis=1), supplies)
            np.testing.assert_array_equal(flows.sum(axis=0), caps)
            ref_flows, _ = transport_assign(cost_u, supplies, caps)
            np.testing.assert_allclose(float((flows * cost_u).sum()),
                                       float((ref_flows * cost_u).sum()),
                                       rtol=1e-9)

    def test_native_simplex_optimal_at_pivot_cap_not_cap_hit(self,
                                                             native_libs):
        """A basis that is ALREADY optimal must report success even with
        max_pivots exhausted (regression: the cap check ran before the
        optimality scan, so a warm start that was already optimal — or an
        instance solved on exactly the capth pivot — returned -1 and the
        caller discarded the exact answer for the slow LP path)."""
        import pytest
        from st_dadk_tpu.ops.kmeans_exact import (_native_transport_lib,
                                                  transport_assign_native)
        lib = _native_transport_lib()
        if lib is None:
            pytest.skip("libstdadk_transport.so not built")
        rng = np.random.default_rng(7)
        u, k = 25, 6
        supplies = rng.integers(1, 9, size=u)
        caps = balanced_caps(int(supplies.sum()), k)
        cost_u = np.ascontiguousarray(rng.uniform(size=(u, k)), np.float64)
        out = transport_assign_native(cost_u, supplies, caps)
        if out is None:
            pytest.skip("native solve failed")
        flows, (flow, basis) = out
        # warm re-solve of the SAME instance with a zero pivot budget: the
        # basis is optimal, so this must succeed with 0 pivots, not -1
        status = lib.stdadk_transport_simplex(
            u, k, cost_u, np.ascontiguousarray(supplies, np.int64),
            np.ascontiguousarray(caps, np.int64), flow, basis, 1, 0)
        assert status == 0

    def test_seeding_survives_degenerate_potential(self):
        """k > n_unique: after all unique sites are chosen, remaining
        k-means++ potentials are 0 — seeding must fall back to uniform
        (the crash found on the Fixed_Clustered A/B, site-wise obs)."""
        rng = np.random.default_rng(13)
        sites = rng.uniform(size=(5, 2))
        X = np.repeat(sites, 40, axis=0)            # 200 points, 5 unique
        centers, labels = kmeans_constrained(X, 8, n_init=1, max_iter=5)
        assert np.isfinite(centers).all()
        sizes = np.bincount(labels, minlength=8)
        assert sizes.sum() == 200 and sizes.max() <= 26


class TestDispatcherIntegration:
    def test_init_spatial_centers_kmeans_exact(self):
        from st_dadk_tpu.ops.init_centers import init_spatial_centers
        rng = np.random.default_rng(6)
        X = rng.uniform(size=(400, 2)).astype(np.float32)
        np.random.seed(0)
        c, bw = init_spatial_centers("kmeans_exact", [9, 16], X)
        assert c.shape == (25, 2) and bw.shape == (25,)
        assert np.all(bw > 0)
        assert np.all((c >= 0) & (c <= 1))

    def test_batch_matches_sequential(self):
        import jax
        import jax.numpy as jnp
        from st_dadk_tpu.ops.init_centers import (init_spatial_centers,
                                                  init_spatial_centers_batch)
        rng = np.random.default_rng(7)
        coords = [rng.uniform(size=(300, 2)).astype(np.float32)
                  for _ in range(2)]
        states = []
        for i in range(2):
            np.random.seed(77 + i)
            states.append(np.random.get_state())
        seq = []
        for i in range(2):
            np.random.set_state(states[i])
            seq.append(init_spatial_centers("kmeans_exact", [9], coords[i],
                                            key=jax.random.PRNGKey(i)))
        keys = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
        bat = init_spatial_centers_batch("kmeans_exact", [9], coords, keys,
                                         rng_states=states)
        for (c1, b1), (c2, b2) in zip(seq, bat):
            np.testing.assert_array_equal(c2, c1)
            np.testing.assert_array_equal(b2, b1)
