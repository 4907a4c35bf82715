"""Multi-host mesh path (parallel/multihost.py).

No cluster is available here, so the host-group layout logic is exercised
with fake device objects (grouping, hybrid grid placement, per-process lane
slices) and the single-host degradations run on the virtual 8-device CPU
mesh (conftest forces JAX_PLATFORMS=cpu with 8 host devices).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu.parallel.multihost import (
    _hybrid_grid,
    experiment_mesh_auto,
    group_devices_by_dcn,
    hybrid_mesh,
    maybe_initialize_distributed,
    process_lane_slice,
    shard_lanes_multihost,
)


class FakeDev:
    def __init__(self, id, process_index, slice_index=None):
        self.id = id
        self.process_index = process_index
        if slice_index is not None:
            self.slice_index = slice_index

    def __repr__(self):
        return f"d{self.id}"


def _pod(n_hosts, per_host, slices=None):
    devs = []
    for h in range(n_hosts):
        for i in range(per_host):
            devs.append(FakeDev(h * per_host + i, h,
                                None if slices is None else h // slices))
    return devs


class TestGrouping:
    def test_groups_by_process(self):
        devs = _pod(2, 4)
        groups = group_devices_by_dcn(devs)
        assert [len(g) for g in groups] == [4, 4]
        assert [d.id for d in groups[0]] == [0, 1, 2, 3]
        assert [d.id for d in groups[1]] == [4, 5, 6, 7]

    def test_slice_index_wins_over_process(self):
        # 4 hosts forming 2 slices of 2 hosts each -> 2 DCN groups
        devs = _pod(4, 2, slices=2)
        groups = group_devices_by_dcn(devs)
        assert [len(g) for g in groups] == [4, 4]
        assert [d.id for d in groups[0]] == [0, 1, 2, 3]

    def test_ordering_is_permutation_invariant(self):
        devs = _pod(2, 4)
        rng = np.random.default_rng(0)
        shuffled = [devs[i] for i in rng.permutation(len(devs))]
        a = group_devices_by_dcn(devs)
        b = group_devices_by_dcn(shuffled)
        assert [[d.id for d in g] for g in a] == [[d.id for d in g] for g in b]


class TestHybridGrid:
    def test_exp_across_hosts_data_within(self):
        groups = group_devices_by_dcn(_pod(2, 4))
        grid = _hybrid_grid(("exp", "data"), (2, 4), 0, groups)
        # every data row (fixed exp coordinate) lives entirely on one host
        for e in range(2):
            hosts = {grid[e, j].process_index for j in range(4)}
            assert hosts == {e}

    def test_multiple_lanes_per_group(self):
        groups = group_devices_by_dcn(_pod(2, 4))
        grid = _hybrid_grid(("exp", "data"), (4, 2), 0, groups)
        for e in range(4):
            hosts = {grid[e, j].process_index for j in range(2)}
            assert hosts == {e // 2}
        # all 8 devices used exactly once
        ids = sorted(d.id for d in grid.ravel())
        assert ids == list(range(8))

    def test_dcn_axis_not_first(self):
        groups = group_devices_by_dcn(_pod(2, 4))
        grid = _hybrid_grid(("data", "exp"), (4, 2), 1, groups)
        for e in range(2):
            hosts = {grid[j, e].process_index for j in range(4)}
            assert hosts == {e}

    def test_errors(self):
        groups = group_devices_by_dcn(_pod(2, 4))
        with pytest.raises(ValueError, match="multiple"):
            _hybrid_grid(("exp", "data"), (3, 2), 0, groups)  # 3 % 2 != 0
        with pytest.raises(ValueError):
            hybrid_mesh({"data": 8}, dcn_axis="exp")  # axis missing


class TestSingleHostDegradation:
    @pytest.mark.skipif(len(jax.devices()) != 8,
                        reason="hybrid_mesh({'exp':4,'data':2}) needs "
                               "exactly 8 devices")
    def test_hybrid_mesh_runs_pjit(self):
        mesh = hybrid_mesh({"exp": 4, "data": 2})
        assert mesh.shape == {"exp": 4, "data": 2}
        x = jnp.arange(8.0).reshape(4, 2)
        from jax.sharding import NamedSharding, PartitionSpec as P
        xs = jax.device_put(x, NamedSharding(mesh, P("exp", "data")))
        assert float(jnp.sum(xs)) == 28.0

    def test_experiment_mesh_auto_all_devices(self):
        mesh = experiment_mesh_auto()
        assert mesh.shape == {"exp": len(jax.devices())}

    def test_lane_slice_single_process(self):
        mesh = experiment_mesh_auto()
        assert process_lane_slice(12, mesh) == slice(0, 12)

    def test_shard_lanes_single_process_matches_device_put(self):
        mesh = experiment_mesh_auto()
        tree = {"a": np.arange(16.0).reshape(8, 2)}
        out = shard_lanes_multihost(tree, mesh)
        np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"])
        assert out["a"].sharding.spec == jax.sharding.PartitionSpec("exp")

    def test_initialize_noop_without_cluster(self, monkeypatch):
        for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
            monkeypatch.delenv(var, raising=False)
        assert maybe_initialize_distributed() is False

    def test_initialize_noop_single_worker_hostnames(self, monkeypatch):
        # only a coordinator address makes a cluster: process-count and
        # process-id variables alone (a single-host launcher's leftovers)
        # must not start jax.distributed
        for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
        called = []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: called.append(kw))
        assert maybe_initialize_distributed() is False
        assert called == []


class TestProcessLaneSlice:
    def _fake_mesh(self, n_hosts=2, lanes=4):
        per = lanes // n_hosts
        devs = np.array([FakeDev(i, i // per) for i in range(lanes)],
                        dtype=object)
        return types.SimpleNamespace(shape={"exp": lanes},
                                     axis_names=("exp",),
                                     devices=devs)

    def test_two_process_split(self):
        mesh = self._fake_mesh(2, 4)
        s0 = process_lane_slice(8, mesh, process_index=0, process_count=2)
        s1 = process_lane_slice(8, mesh, process_index=1, process_count=2)
        assert (s0, s1) == (slice(0, 4), slice(4, 8))

    def test_indivisible_batch_raises(self):
        mesh = self._fake_mesh(2, 4)
        with pytest.raises(ValueError, match="divide"):
            process_lane_slice(6, mesh, process_index=0, process_count=2)

    def test_noncontiguous_layout_raises(self):
        devs = np.array([FakeDev(0, 0), FakeDev(1, 1),
                         FakeDev(2, 0), FakeDev(3, 1)], dtype=object)
        mesh = types.SimpleNamespace(shape={"exp": 4}, axis_names=("exp",),
                                     devices=devs)
        with pytest.raises(ValueError, match="contiguous"):
            process_lane_slice(4, mesh, process_index=0, process_count=2)
