"""Where compiled programs are cached (qldpc_jax.enable_compilation_cache).

Each case runs in a fresh interpreter so the process-wide JAX cache
configuration of the test worker is left alone."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp, qldpc_jax
qldpc_jax.enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.arange(7.0)).block_until_ready()
print("CACHE_DIR", jax.config.jax_compilation_cache_dir)
"""


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_extra)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("CACHE_DIR")]
    return line[-1].split(" ", 1)[1]


def test_env_dir_is_used_untouched(tmp_path):
    target = tmp_path / "x"
    assert _probe({"JAX_COMPILATION_CACHE_DIR": str(target)}) == str(target)
    assert target.is_dir() and any(target.iterdir())


def test_default_dir_is_fixed_inside_checkout():
    assert _probe({}) == os.path.join(REPO, ".jax_cache")
