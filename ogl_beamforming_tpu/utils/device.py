"""The accelerator a run uses: its description and the compile cache."""

from __future__ import annotations

import os
import subprocess

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache in
    ``$JAX_COMPILATION_CACHE_DIR`` when it is set, else in
    ``<checkout>/.jax_cache``.  The path is part of the cache key, so it is
    fixed.  Returns the directory."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (a
    card set below its top power limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device as JAX reports it (platform, kind, count), or
    RuntimeError when JAX found no GPU: measurements on the card never fall
    back to another platform."""
    devices = jax.devices()
    info = {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
    if info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {info['platform']} "
                           f"({info['kind']})")
    return info
