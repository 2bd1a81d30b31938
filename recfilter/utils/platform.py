"""Platform selection and the persistent compile cache.

The reference selects its backend at runtime via the ``HL_JIT_TARGET`` env
var (``lib/recfilter.cpp:135-138``); the equivalent here is
``RECFILTER_PLATFORM`` (``cpu`` or ``gpu``), applied through jax.config
before any backend initializes. Scripts call :func:`apply_platform_env`
first thing; it does nothing unless the variable is set, so no run is ever
moved to the CPU without asking.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path (the cache key includes it), listed in
# .gitignore.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def apply_platform_env() -> None:
    plat = os.environ.get("RECFILTER_PLATFORM", "")
    if not plat:
        return
    import jax

    jax.config.update("jax_platforms", plat)
    if plat == "cpu" and "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""
    ):
        ndev = os.environ.get("RECFILTER_CPU_DEVICES", "")
        if ndev:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={ndev}"
            ).strip()


def configure_compile_cache(environ=os.environ) -> str:
    """Point JAX's persistent compile cache at its directory and return it.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads that
    directory and nothing is set here; otherwise the cache goes to
    :data:`CACHE_DIR` inside the checkout."""
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
