"""Multi-host (multi-process) mesh path: jax.distributed + host-aware layout.

The reference's only scaling mechanism is a single-machine joblib pool
(train_st_interp.py:2945-2991). Across several GPU hosts the equivalent
scale-out axis is a multi-host SPMD program: one Python process per host,
every process runs the same code, and jax gives each process a global view
of all devices once `jax.distributed.initialize()` has run.

Design rules, applied to this framework's axes. The cards of one host are
joined by NVLink; hosts talk over the (much slower) network between them:

  - 'exp' lanes are embarrassingly parallel (zero steady-state collectives,
    SURVEY.md section 2.4) — so the 'exp' axis is laid out ACROSS hosts: no
    collective ever crosses the network.
  - 'data' / 'tp' axes carry pmean/psum every step — they are laid out WITHIN
    a host's local devices so their collectives ride NVLink only.

(The code calls a host group a "DCN group", jax's name for the slow
interconnect between groups of devices.)

Nothing here requires a cluster to import: on a single host every function
degrades to the plain single-process behavior, which is how the unit tests
(virtual 8-device CPU mesh) exercise the layout logic.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_DISTRIBUTED_READY = False


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running as one process of a cluster.

    Safe to call unconditionally at CLI startup:
      - explicit args win;
      - else a cluster is read from JAX_COORDINATOR_ADDRESS (or
        COORDINATOR_ADDRESS) with JAX_NUM_PROCESSES / JAX_PROCESS_ID;
      - otherwise (single host) it is a no-op and returns False.

    Returns True when distributed mode is (already) initialized.
    """
    global _DISTRIBUTED_READY
    if _DISTRIBUTED_READY:
        return True
    explicit = coordinator_address is not None
    env = (os.environ.get("JAX_COORDINATOR_ADDRESS")
           or os.environ.get("COORDINATOR_ADDRESS"))
    if not (explicit or env):
        return False
    kwargs = {}
    if explicit:
        kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
    elif env:
        kwargs["coordinator_address"] = env
        if os.environ.get("JAX_NUM_PROCESSES"):
            kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
        if os.environ.get("JAX_PROCESS_ID"):
            kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        # the environment names no usable cluster (or initialize was
        # already called); a single-host run must never die here
        if explicit:
            raise
        print(f"[WARNING] jax.distributed.initialize skipped: {e}")
        return False
    _DISTRIBUTED_READY = True
    return True


def _group_key(d) -> int:
    """Group of a device: its `slice_index` where the backend reports one,
    else its host (process)."""
    s = getattr(d, "slice_index", None)
    if s is not None:
        return int(s)
    return int(getattr(d, "process_index", 0))


def group_devices_by_dcn(devices: Optional[Sequence] = None) -> List[List]:
    """Partition devices into host groups, each sorted by id.

    Groups are ordered by group key so every process computes the same
    global ordering (a multi-host requirement: Mesh device order must be
    identical across processes)."""
    devices = list(devices if devices is not None else jax.devices())
    groups: Dict[int, List] = {}
    for d in devices:
        groups.setdefault(_group_key(d), []).append(d)
    out = []
    for k in sorted(groups):
        out.append(sorted(groups[k], key=lambda d: int(getattr(d, "id", 0))))
    return out


def hybrid_mesh(axes: Dict[str, int],
                dcn_axis: str = "exp",
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh whose `dcn_axis` strides across host groups, other axes within
    one host.

    axes maps axis name -> size, in mesh order. The `dcn_axis` size must be a
    multiple of the number of DCN groups (each group contributes
    size/n_groups consecutive coordinates of that axis); all remaining axes
    must fit inside one group's devices. With one group (single host, single
    slice) this reduces to `make_mesh` exactly.

    Example on 2 hosts x 4 GPUs:
        hybrid_mesh({"exp": 4, "data": 2})
    gives 4 experiment lanes (2 per host), each data-parallel over 2 GPUs of
    ONE host — the per-step pmean never leaves the host's NVLink.
    """
    groups = group_devices_by_dcn(devices)
    n_groups = len(groups)
    per_group = len(groups[0])
    if any(len(g) != per_group for g in groups):
        raise ValueError("DCN groups are unequal; cannot build a hybrid mesh")
    if dcn_axis not in axes:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in axes {axes}")
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    total = int(np.prod(shape))
    if total != n_groups * per_group:
        raise ValueError(f"mesh {axes} needs {total} devices, have "
                         f"{n_groups * per_group}")
    grid = _hybrid_grid(names, shape, names.index(dcn_axis), groups)
    return Mesh(grid, names)


def _hybrid_grid(names, shape, dcn_pos: int, groups: List[List]) -> np.ndarray:
    """Device grid for hybrid_mesh; separated so layout logic is unit-testable
    with fake device objects (a real Mesh requires real jax devices)."""
    n_groups = len(groups)
    per_group = len(groups[0])
    dcn_size = shape[dcn_pos]
    total = int(np.prod(shape))
    if dcn_size % n_groups != 0:
        raise ValueError(f"{names[dcn_pos]}={dcn_size} must be a multiple of "
                         f"the {n_groups} DCN group(s)")
    ici_total = total // dcn_size            # devices per dcn coordinate
    lanes_per_group = dcn_size // n_groups
    if lanes_per_group * ici_total != per_group:
        raise ValueError("ICI axes do not fit inside one DCN group")

    # global device order: the dcn axis advances through groups, everything
    # else within a group; within a group devices are consumed in
    # (lane, ici_offset) order.
    grid = np.empty(shape, dtype=object)
    cursors = np.zeros(n_groups, np.int64)
    for idx in np.ndindex(*shape):
        dcn_coord = idx[dcn_pos]
        g = dcn_coord // lanes_per_group
        grid[idx] = groups[g][int(cursors[g])]
        cursors[g] += 1
    return grid


def experiment_mesh_auto(axis: str = "exp",
                         devices: Optional[Sequence] = None) -> Mesh:
    """All-device 'exp' mesh with a host-aware device order.

    Single host: Mesh(jax.devices(), (axis,)). Multi-host: lanes are grouped
    so each host holds a contiguous lane block (pure layout hygiene — exp
    has no collectives — but it keeps any future cross-lane reduction
    local-first)."""
    groups = group_devices_by_dcn(devices)
    flat = [d for g in groups for d in g]
    return Mesh(np.array(flat, dtype=object), (axis,))


def process_lane_slice(M: int, mesh, axis: str = "exp",
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> slice:
    """The half-open lane range [lo, hi) this process must materialize.

    Multi-host jit consumes jax.Arrays assembled from per-process shards
    (`shard_lanes_multihost`); each process only loads/synthesizes the lanes
    that live on ITS devices. Lanes are laid out contiguously over the mesh's
    `axis`, so the slice is proportional to the process's share of that axis.
    Single-process: slice(0, M). `process_index`/`process_count` default to
    the live jax values (overridable for layout tests)."""
    if process_count is None:
        process_count = jax.process_count()
    if process_index is None:
        process_index = jax.process_index()
    if process_count == 1:
        return slice(0, M)
    axis_size = mesh.shape[axis]
    if M % axis_size != 0:
        raise ValueError(f"M={M} lanes must divide over {axis}={axis_size} "
                         "for multi-host lane assembly (pad the batch)")
    # which coordinates of `axis` live on this process's devices
    names = list(mesh.axis_names)
    ax = names.index(axis)
    local = set()
    pid = process_index
    for idx in np.ndindex(*mesh.devices.shape):
        if mesh.devices[idx].process_index == pid:
            local.add(idx[ax])
    lo, hi = min(local), max(local) + 1
    if len(local) != hi - lo:
        raise ValueError("this process's lane coordinates are not contiguous;"
                         " use hybrid_mesh/experiment_mesh_auto layouts")
    per = M // axis_size
    return slice(lo * per, hi * per)


def process_info() -> tuple:
    """(process_count, process_index) — the one seam batch-engine gating
    consults, so tests can monkeypatch a fake pod onto a single machine."""
    return jax.process_count(), jax.process_index()


def is_primary() -> bool:
    """True on the process that owns cross-lane aggregation/summary IO."""
    return process_info()[1] == 0


def shared_timestamp():
    """A datetime identical on EVERY process (epoch seconds broadcast from
    the primary). Default output directories derive from this instead of a
    per-process datetime.now(): two hosts crossing a second boundary would
    otherwise write their owned lanes into different trees, and the
    primary's aggregation re-scan would silently drop the other host's
    experiments. Single-process: plain now()."""
    import datetime
    import time as _time
    ts = _time.time()
    if process_info()[0] > 1:
        from jax.experimental import multihost_utils
        ts = float(np.asarray(multihost_utils.broadcast_one_to_all(
            np.asarray(ts, np.float64))))
    return datetime.datetime.fromtimestamp(ts)


def sync_processes(name: str = "st_dadk_barrier") -> None:
    """Cross-process barrier (no-op single-process).

    Used between per-lane artifact writes and primary-process aggregation so
    the summary pass on process 0 sees every host's results.json on the
    shared filesystem."""
    if process_info()[0] > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def fetch_lane_rows(x, sl: slice) -> np.ndarray:
    """Host-fetch rows [sl] of a lane-major (global axis 0) jax array.

    Fully addressable arrays (single process, or replicated) go through one
    plain transfer. On a multi-process mesh a global jax.Array spans
    non-addressable devices and np.asarray() raises — there, the requested
    rows are assembled from this process's addressable shards (which is why
    callers must request only their `process_lane_slice` block)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)[sl]
    n_rows = sl.stop - sl.start
    if n_rows <= 0:
        # a process can own zero REAL lanes (all its rows are pad dups);
        # it still participates in the SPMD dispatches, just writes nothing
        dtype = np.dtype(getattr(x, "dtype", np.float32))
        return np.empty((0,) + tuple(x.shape[1:]), dtype)
    out = None
    filled = np.zeros(n_rows, bool)
    for shard in x.addressable_shards:
        i0 = shard.index[0] if shard.index else slice(None)
        start = i0.start if i0.start is not None else 0
        stop = i0.stop if i0.stop is not None else x.shape[0]
        lo, hi = max(start, sl.start), min(stop, sl.stop)
        if lo >= hi:
            continue
        data = np.asarray(shard.data)
        if out is None:
            out = np.empty((n_rows,) + tuple(x.shape[1:]), data.dtype)
        out[lo - sl.start:hi - sl.start] = data[lo - start:hi - start]
        filled[lo - sl.start:hi - sl.start] = True
    if out is None or not filled.all():
        raise ValueError(
            f"lane rows {sl} are not addressable on process "
            f"{process_info()[1]}; request only process_lane_slice rows")
    return out


def fetch_lane_tree(tree, sl: slice):
    """fetch_lane_rows over every leaf of a lane-major pytree."""
    return jax.tree_util.tree_map(lambda x: fetch_lane_rows(x, sl), tree)


def shard_lanes_multihost(tree, mesh: Mesh, axis: str = "exp"):
    """Place a GLOBALLY-shaped stacked pytree, lane axis sharded over `axis`.

    Single-process: plain device_put with the lane sharding.
    Multi-process: each process slices out its own lane block
    (`process_lane_slice` rows) and the global jax.Array is assembled with
    `jax.make_array_from_process_local_data` — only the local lanes' bytes
    are uploaded on each host. (Hosts still synthesize the full stack on CPU
    today; streaming per-host setup is the future refinement and only needs
    the caller to build `process_lane_slice` lanes.)"""
    s = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(tree, s)

    def place(x):
        x = np.asarray(x)
        sl = process_lane_slice(x.shape[0], mesh, axis)
        return jax.make_array_from_process_local_data(s, x[sl], x.shape)

    return jax.tree_util.tree_map(place, tree)
