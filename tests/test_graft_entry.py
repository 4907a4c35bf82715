"""Bootstrap-path tests for the driver gates in __graft_entry__.py.

The dry run itself (minutes of compile) is exercised by CI's dedicated
step; these tests pin the *dispatch logic* — which invocation environments
run inline vs re-exec a virtual-CPU-mesh child — because a wrong branch
there silently validates nothing. See __graft_entry__.dryrun_multichip.
"""
import os
import sys
from pathlib import Path
from unittest import mock

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as ge


@pytest.fixture
def no_impl(monkeypatch):
    """Stub the heavy pieces; record which path ran."""
    calls = {"impl": 0, "reexec": 0, "env": None}

    def fake_impl(n):
        calls["impl"] += 1

    def fake_call(argv, env=None):
        calls["reexec"] += 1
        calls["env"] = env
        return 0

    monkeypatch.setattr(ge, "_dryrun_impl", fake_impl)
    monkeypatch.setattr("subprocess.call", fake_call)
    return calls


def test_no_env_preset_reexecs_child(no_impl, monkeypatch):
    monkeypatch.delenv(ge._CHILD_ENV, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")  # a GPU host's setting
    ge.dryrun_multichip(8)
    assert no_impl["reexec"] == 1 and no_impl["impl"] == 0
    env = no_impl["env"]
    assert env[ge._CHILD_ENV] == "1"
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]


def test_child_runs_inline(no_impl, monkeypatch):
    monkeypatch.setenv(ge._CHILD_ENV, "1")
    ge.dryrun_multichip(8)
    assert no_impl["impl"] == 1 and no_impl["reexec"] == 0


def test_preset_env_with_live_cpu_mesh_runs_inline(no_impl, monkeypatch):
    # conftest already forces the live jax config onto the 8-device CPU
    # mesh, so the preset path's device-count check passes and no child
    # process is needed.
    monkeypatch.delenv(ge._CHILD_ENV, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    ge.dryrun_multichip(8)
    assert no_impl["impl"] == 1 and no_impl["reexec"] == 0


def test_preset_env_but_wrong_backend_falls_back_to_reexec(no_impl,
                                                           monkeypatch):
    # The env promises an 8-device CPU mesh but the process's backend is
    # already initialized elsewhere (e.g. entry() touched the GPU first):
    # the preset path must detect the mismatch and re-exec.
    monkeypatch.delenv(ge._CHILD_ENV, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: [object()])  # 1 device
    ge.dryrun_multichip(8)
    assert no_impl["reexec"] == 1 and no_impl["impl"] == 0


def test_preset_env_narrower_than_requested_reexecs(no_impl, monkeypatch):
    monkeypatch.delenv(ge._CHILD_ENV, raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    ge.dryrun_multichip(8)
    assert no_impl["reexec"] == 1 and no_impl["impl"] == 0
    # the narrow preset is REWRITTEN to the requested width — inheriting
    # it would fail the child's device-count assert
    assert ("xla_force_host_platform_device_count=8"
            in no_impl["env"]["XLA_FLAGS"])
    assert ("device_count=4" not in no_impl["env"]["XLA_FLAGS"])
