"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without accelerators; whatever needs the GPU is a phase of
chip_smoke.py. Env vars must be set before jax initializes its backends,
hence before any jax import.
"""
import os

# Hard-set (not setdefault): the suite must never reach an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_enable_fast_math" not in _flags:
    # XLA-CPU fast-math exp/log approximations cost ~1e-5 relative error,
    # which breaks tight numeric parity assertions
    _flags = (_flags + " --xla_cpu_enable_fast_math=false").strip()
os.environ["XLA_FLAGS"] = _flags
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import pytest  # noqa: E402

import jax  # noqa: E402

# ---------------------------------------------------------------------------
# Fast test lane (`make test-fast` = -m "not slow"): tests measured >= ~5 s
# on the reference dev box (single CPU core, --durations run 2026-08-17) are
# marked slow so the inner-loop suite stays under ~3 minutes. CI and
# `make test` still run everything.
# ---------------------------------------------------------------------------
_SLOW_PREFIXES = (
    # BOTH consumers of the module-scoped grid_results fixture must be slow,
    # or the fast lane still pays the real grid search through the survivor.
    "test_analysis.py::test_analyze_grid_search",
    "test_analysis.py::test_resume_summarize_only",
    "test_batch_engine.py::TestBatchEngine",
    "test_batch_engine.py::TestMultiQuantileBatch",
    "test_batch_engine.py::TestPerTauVmapEngine",
    "test_batch_engine.py::TestTailCompaction",
    "test_batch_engine.py::TestUnequalLaneCapacity",
    "test_checkpoint.py::test_resume_bitwise_equals_uninterrupted",
    "test_checkpoint.py::test_orbax_backend_resume_bitwise",
    "test_checkpoint.py::test_session_budget_not_a_chunk_multiple",
    "test_data_parallel.py::TestDataParallelFit",
    "test_data_parallel.py::TestHybridExpDataMesh",
    "test_forecaster.py::TestForecasterTraining",
    "test_init_centers.py::TestCrossEngineInitEquality",
    "test_init_centers.py::TestKActiveMasking",
    "test_kmeans_exact.py::TestAuctionExactness",
    "test_multihost_finalize.py::TestGatedFinalize",
    "test_multiprocess_cluster.py::",
    "test_ragged_k.py::TestRaggedStacking::test_ragged_batch",
    "test_ragged_k.py::TestRaggedGridSearch",
    "test_reference_parity.py::test_forward_parity_mean",
    "test_spatial_only.py::test_1a_end_to_end",
    "test_sweep.py::",
    "test_tensor_parallel.py::TestTPTrainStep",
    "test_train_loop.py::TestDeltaPenaltyModes",
    "test_train_loop.py::TestDropoutRng",
    "test_train_loop.py::TestFitLearnableBasis",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: integration tests >= ~5 s; excluded by "
        "`make test-fast` (-m 'not slow')")


def pytest_collection_modifyitems(config, items):
    for item in items:
        nid = item.nodeid.split("tests/")[-1]
        if any(nid.startswith(p) for p in _SLOW_PREFIXES):
            item.add_marker(pytest.mark.slow)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
assert jax.default_backend() == "cpu", "tests must run on CPU"
assert len(jax.devices()) >= 8, "expected the virtual 8-device CPU mesh"

from st_dadk_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture(scope="session")
def ref_data_root():
    """Path to the KAUST datasets; tests that need real data skip if absent."""
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / "data"
    if (root / "2a").exists():
        return root
    pytest.skip("KAUST data not available")


@pytest.fixture(scope="session")
def native_libs():
    """Build native/*.so once (`make -C native`, serialized across test
    workers by a file lock) and return whether both libraries loaded."""
    import fcntl
    import subprocess
    from pathlib import Path

    from st_dadk_tpu.dataio import native
    from st_dadk_tpu.ops import kmeans_exact

    root = Path(__file__).resolve().parent.parent / "native"
    with open(root / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(root)], capture_output=True)
    # forget earlier failed loads in this worker
    native._lib, native._load_failed = None, False
    kmeans_exact._NATIVE_LIB, kmeans_exact._NATIVE_TRIED = None, False
    return (native.native_available()
            and kmeans_exact._native_transport_lib() is not None)
