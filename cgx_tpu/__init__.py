"""cgx_tpu: hierarchical translation grammar extraction in JAX.

Importing the package turns on JAX's persistent compilation cache: the device
stages compile to many programs (one per pow2 dispatch size), and the cache
lets a later process load them instead of compiling them again.  The cache
lives where ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that variable
itself); when it is unset, at ``.jax_cache`` in the checkout — a fixed path,
because the path is part of what makes a later process find the entries.
"""

import os as _os

import jax as _jax

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
