"""Process set-up shared by the entry points: backend selection, the
persistent compile cache, and the accelerator check of measurement runs.

Every CLI calls `apply_platform_env()` before its first jax use, so

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/train_st_interp.py ...

lands on a virtual CPU mesh or fails loudly, and `enable_compile_cache()` so
a second run of the same programs loads them instead of compiling again.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parent.parent.parent
DEFAULT_CACHE_DIR = REPO / ".jax_cache"


def apply_platform_env() -> None:
    """Force the live jax config to match the JAX_PLATFORMS env var.

    No-op when the variable is unset (jax picks its default backend). Must
    run before the first backend initialization (device query / first
    dispatch); raises if a different backend is already live, since every
    op would then run on a device the caller did not ask for."""
    plats = os.environ.get("JAX_PLATFORMS", "").strip().lower()
    if not plats:
        return
    import jax
    jax.config.update("jax_platforms", plats)
    # the config update does not fail once a backend is initialized, so
    # check the live backend itself
    backend = jax.default_backend()
    if plats.split(",")[0] != backend:
        raise RuntimeError(f"JAX_PLATFORMS={plats} requested but the "
                           f"{backend!r} backend is already initialized")


def enable_compile_cache() -> str:
    """Turn on jax's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, names the directory (jax reads it
    itself) and nothing else is set; otherwise the cache lives in
    `<repo>/.jax_cache`. Call before the first compilation."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(DEFAULT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each ("name, limit"). Runs in a child process that never touches jax."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(min_devices: int = 1) -> Dict[str, object]:
    """The accelerator check of every measurement path: the first jax device
    must be a GPU (no CPU fallback) and at least `min_devices` must be
    visible. Returns the device description that results are printed
    beside: platform, device_kind, count, and the cards' name and power
    limit as nvidia-smi reports them."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU: jax's first device is "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < min_devices:
        raise SystemExit(f"needs {min_devices} GPUs, jax sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power_limit()}
