"""qldpc_jax — quantum LDPC decoding framework in JAX.

A from-scratch JAX/XLA/Pallas framework covering the capabilities of the
reference qLDPC research codebase (BB codes, BP/min-sum decoding, OSD
post-processing, Monte-Carlo logical-error-rate studies), redesigned for
accelerators: batched edge-list message passing under ``lax.scan``,
bit-packed on-device GF(2) elimination, and mesh-sharded Monte-Carlo
counting.
"""

import os as _os

from qldpc_jax import codes

__version__ = "0.1.0"

# fixed location inside the checkout: the cache key includes the path, so a
# cache directory that moves never hits
_DEFAULT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Persist compiled executables across processes.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already caches there and
    nothing is changed here. Otherwise the cache goes to ``.jax_cache`` at
    the root of the checkout."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    _os.makedirs(_DEFAULT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
