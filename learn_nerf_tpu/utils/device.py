"""Process set-up shared by the CLIs, the benchmark and the smoke run:
the persistent compile cache, the GPU gate, and the card's identity.

One JAX process reserves most of a card's memory when it first touches
it, so a second process on the same card fails for want of memory: each
card is driven by one process.
"""

import os
import subprocess
from pathlib import Path

import jax

#: Fixed cache location used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
#: The path is part of each cache entry's key, so it never depends on a
#: temporary name, a process id or the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache goes to ``<repo>/.jax_cache``.
    Returns the directory in use.  Call before the first compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)


def require_gpu() -> list:
    """The process's devices; raises ``SystemExit`` unless they are GPUs.

    Measurement paths never fall back to the CPU: a number taken there is
    not a device number.
    """
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found (JAX platform {devices[0].platform!r}); this "
            f"path measures the card and has no CPU fallback"
        )
    return devices


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    devices = jax.devices()
    return dict(
        platform=devices[0].platform,
        kind=devices[0].device_kind,
        count=len(devices),
    )


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
