"""Serialized-executable warm-open cache (VERDICT r4 missing #3).

``aot.jit`` is a drop-in for ``jax.jit`` on SINGLE-DEVICE programs that, when
enabled, persists each compiled executable (PJRT serialization via
``jax.experimental.serialize_executable``) and loads it back in later
processes with ``deserialize_and_load`` — skipping the trace, lowering and
persistent-cache lookup of each program on warm open.  Whether that cuts
set-up time on the GPU is unmeasured (ROADMAP G1).

Correctness model:
* cache key = sha256 of the LOWERED stablehlo text (exact code+shape+static
  identity — a code change or shape change can never hit a stale entry) plus
  the backend platform;
* executables are device-bound: the AOT path engages only when every array
  argument lives on one device and that device is recorded in the fast key;
* any failure (serialize unsupported, version mismatch, deserialize error)
  falls back to the plain jit call for that key, permanently, with one
  stderr note.

Enablement: ``CGX_AOT_CACHE=<dir>`` (or ``enable(dir)``, used by serve's
``--aot-cache``).  Off by default — the standard jit path is untouched.

Steady-state cost when enabled: one dict lookup on a (shapes, dtypes,
statics, device) fast key per call; lowering/tracing happens once per key.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys
import threading

_LOCK = threading.Lock()
_DIR = [os.environ.get("CGX_AOT_CACHE") or None]


def enable(directory: str):
    """Turn the executable cache on for this process (serve --aot-cache)."""
    _DIR[0] = directory


def enabled():
    return _DIR[0] is not None


def _fast_key(args, statics):
    import jax

    parts = [repr(sorted(statics.items()))]
    for a in args:
        if isinstance(a, jax.Array):
            devs = a.devices()
            if len(devs) != 1:
                return None               # multi-device arg: bypass
            parts.append(f"{a.shape}/{a.dtype}/d{next(iter(devs)).id}")
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            parts.append(f"{a.shape}/{a.dtype}/host")
        else:
            parts.append(repr(a))         # python scalar leaf
    return "|".join(parts)


class _AotJit:
    """jax.jit wrapper with a persistent serialized-executable cache."""

    def __init__(self, fn, static_argnames=()):
        import jax
        import functools
        import inspect

        self._static = tuple(static_argnames) if static_argnames else ()
        self._jit = jax.jit(fn, static_argnames=self._static) \
            if self._static else jax.jit(fn)
        params = list(inspect.signature(fn).parameters)
        self._static_pos = {params.index(n) for n in self._static
                            if n in params}
        self._compiled = {}
        self._broken = set()
        functools.update_wrapper(self, fn)

    # jax.jit API surface used in this repo
    def lower(self, *args, **kwargs):
        return self._jit.lower(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not enabled():
            return self._jit(*args, **kwargs)
        statics = {k: kwargs[k] for k in self._static if k in kwargs}
        dyn_kwargs = {k: v for k, v in kwargs.items() if k not in statics}
        if dyn_kwargs:                     # dynamic kwargs: keep it simple
            return self._jit(*args, **kwargs)
        # statics may also arrive positionally: split them out so the
        # Compiled object is called with dynamic args only
        dyn_args = [a for i, a in enumerate(args)
                    if i not in self._static_pos]
        fk = _fast_key(args, statics)
        if fk is None or fk in self._broken:
            return self._jit(*args, **kwargs)
        comp = self._compiled.get(fk)
        if comp is None:
            try:
                comp = self._load_or_compile(args, statics, dyn_args)
            except Exception as exc:       # any failure: permanent fallback
                print(f"cgx aot: fallback for {self.__name__}: "
                      f"{type(exc).__name__}: {exc}", file=sys.stderr)
                self._broken.add(fk)
                return self._jit(*args, **kwargs)
            self._compiled[fk] = comp
        return comp(*dyn_args)

    def _load_or_compile(self, args, statics, dyn_args):
        import jax
        from jax.experimental import serialize_executable as se

        lowered = self._jit.lower(*args, **statics)
        text = lowered.as_text()
        dev = None
        for a in dyn_args:
            if isinstance(a, jax.Array):
                dev = next(iter(a.devices()))
                break
        if dev is None:
            dev = jax.devices()[0]
        key = hashlib.sha256(
            (dev.platform + "\0" + text).encode()).hexdigest()
        path = os.path.join(_DIR[0], f"{key}.pjrt")
        if os.path.exists(path):
            with open(path, "rb") as fh:
                payload, in_tree, out_tree = pickle.load(fh)
            return se.deserialize_and_load(payload, in_tree, out_tree,
                                           execution_devices=[dev])
        comp = lowered.compile()
        try:
            blob = pickle.dumps(se.serialize(comp))
            with _LOCK:
                os.makedirs(_DIR[0], exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, path)      # atomic: concurrent-safe
        except Exception as exc:           # serialization unsupported: note once
            print(f"cgx aot: persist failed for {self.__name__}: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return comp


def jit(fn=None, *, static_argnames=()):
    """Drop-in for ``jax.jit`` (single-device programs only): adds the
    persistent serialized-executable cache when enabled."""
    if fn is None:
        return lambda f: _AotJit(f, static_argnames)
    return _AotJit(fn, static_argnames)
