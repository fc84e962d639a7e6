"""The one place that points JAX's persistent compile cache somewhere.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at a fixed path inside the
checkout (``.jax_cache/``, listed in .gitignore): the path is part of
what a cached entry is found by, so it must not move between runs.

XLA:CPU AOT executables are compiled against the BUILD host's machine
features and reloaded verbatim on cache hit: a cache populated on one host
reloads on a different host with mismatched features (cpu_aot_loader
"Compile machine features ... vs host machine features" errors, SIGILL
risk) and — worse for us — different fp codegen, which forks the
closed-loop trajectories the golden fixtures pin (PERF.md: keyframe
cadence is chaotically sensitive to fp deltas). So the CPU cache is keyed
by a host signature: one recompile pass per new host instead of a silent
numerics fork.
"""

from __future__ import annotations

import hashlib
import os

_BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def host_sig() -> str:
    """Stable signature of the host's CPU feature set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(flags.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return platform.machine() or "unknown"


def jax_cache_dir(platform: str = "") -> str:
    """Cache directory for the given jax platform ("cpu" is host-keyed)."""
    if platform == "cpu":
        return os.path.join(_BASE, f"cpu-{host_sig()}")
    return _BASE


def configure(platform: str = "", min_compile_secs: float = 1.0) -> str:
    """Enable the persistent compile cache; returns the directory in use.

    ``platform`` is the JAX platform the process will run on ("" = the
    default backend, resolved here). An explicit ``JAX_COMPILATION_CACHE_DIR``
    wins and is left to JAX.
    """
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = jax_cache_dir(platform or jax.default_backend())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
