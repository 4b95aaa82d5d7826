"""Process set-up shared by the launchers: compile cache and device checks."""
import os
import subprocess

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache():
    """Persistent compilation cache.  JAX reads $JAX_COMPILATION_CACHE_DIR
    itself when it is set; otherwise the cache lives at a fixed path in the
    checkout (.jax_cache/, gitignored), since the path is part of the key."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(_REPO, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


def require_gpu():
    """The devices of a measurement: GPUs, or SystemExit.  There is no CPU
    fallback — a CPU number is not a device number."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform} devices "
                         f"({devs[0].device_kind})")
    return devs


def device_fields():
    """platform, device_kind and device count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info():
    """(name, power limit) of the first card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them.  A card below its top power limit runs slower under load, so
    every number is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0]
    name, limit = (p.strip() for p in line.split(",", 1))
    return name, limit
