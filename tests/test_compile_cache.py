"""Where the persistent compilation cache goes: the directory that
JAX_COMPILATION_CACHE_DIR names, else the fixed ``.jax_cache`` in the checkout.
Each case runs in a fresh interpreter, since the package sets the cache up
when it is imported."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).parent.parent

_CHILD = """
import jax, jax.numpy as jnp
import cgx_tpu
print(jax.config.jax_compilation_cache_dir)
if {compile!r}:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()
"""


def _child(env_dir, compile_):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    r = subprocess.run([sys.executable, "-c", _CHILD.format(compile=compile_)],
                       cwd=str(REPO), env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    cache = tmp_path / "cache"
    assert _child(cache, True) == str(cache)
    assert any(cache.iterdir()), "no cache entry written to the named dir"


def test_cache_defaults_to_fixed_path_in_checkout():
    assert _child(None, False) == str(REPO / ".jax_cache")
    ignored = subprocess.run(["git", "check-ignore", "-q", ".jax_cache/x"],
                             cwd=str(REPO))
    assert ignored.returncode == 0, ".jax_cache is not listed in .gitignore"
