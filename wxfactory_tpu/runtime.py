"""Process-level runtime settings: the persistent compile cache and the
platform a run is placed on."""

import os
from typing import List, Optional

import jax

# Config spelling (reference-compatible) -> JAX platform name.
PLATFORMS = {"cpu": "cpu", "cuda": "gpu"}


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache lives in ``.jax_cache`` at the
    root of the checkout that holds this package, so every entry point of
    one checkout shares it from run to run."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def platform_devices(desired_device: Optional[str]) -> List[jax.Device]:
    """The devices of the platform that ``System.desired_device`` names
    (``cpu`` or ``cuda``), or of the platform JAX starts on when it is
    unset. Raises when JAX has no such platform: a run configured for the
    GPU never falls back to the CPU."""
    if desired_device is None:
        return jax.devices()
    if desired_device not in PLATFORMS:
        raise ValueError(f"desired_device must be one of {sorted(PLATFORMS)}, got {desired_device!r}")
    platform = PLATFORMS[desired_device]
    try:
        return jax.devices(platform)
    except RuntimeError as e:
        raise RuntimeError(
            f"desired_device={desired_device!r} needs the JAX {platform!r} platform, "
            f"which is not available here ({e})"
        ) from e
