"""Bucketed batch padding.

Every device stage is a vmap over a flat work-item axis whose length is
data-dependent; without padding each distinct length compiles a fresh XLA program
(seconds each).  ``pad_items`` rounds the
item axis up to the next power of two by repeating the first item (a valid work
item whose duplicated results are sliced off), so programs are reused across
batches and runs."""

from __future__ import annotations

import os
import threading

import numpy as np

MIN_BUCKET = 64

# A/B diagnostic: CGX_SERIAL_COMPILE=1 forces every first-time compile/load
# back onto the dispatching thread (the pre-r3 serial behavior)
PARALLEL_COMPILE_OK = not os.environ.get("CGX_SERIAL_COMPILE")

_POOL = None
_POOL_LOCK = threading.Lock()


def compile_pool():
    """Shared thread pool for first-time program compiles/loads.  A first
    dispatch blocks its thread while its program compiles (or loads from the
    persistent cache); compiles of DISTINCT programs can run concurrently, so
    cold-open cost can drop from sum(compile) toward max(compile).  Whether it
    does on a given host is unmeasured.  Steady-state dispatches never come
    here."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _POOL = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="cgx-compile")
    return _POOL


def bucket_size(n: int) -> int:
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


def pad_items(*arrays, floor: int = 0):
    """Pad each array's leading axis to the common bucket size (at least
    ``floor``) by repeating row 0.  Returns (n_real, padded_arrays...)."""
    n = len(arrays[0])
    m = max(bucket_size(n), floor)
    if m == n:
        return (n,) + tuple(np.ascontiguousarray(a) for a in arrays)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        pad = np.repeat(a[:1], m - n, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return (n,) + tuple(out)


def pad_tokens(tokens: np.ndarray, fill) -> np.ndarray:
    """Bucket-pad a token array with a fill value (for query streams)."""
    n = len(tokens)
    m = bucket_size(n)
    if m == n:
        return tokens
    return np.concatenate([tokens, np.full(m - n, fill, tokens.dtype)])


# Max device items per dispatch.  Larger chunks mean fewer dispatches and
# fetches; smaller ones bound the per-dispatch device temps (a few KB per item
# for the anchored-window kernels) and the padding of the last chunk.
CHUNK = 131072


MIN_CHUNK = 4096  # floor of the pow2 decomposition; below this the tail is padded


def chunk_plan(n: int, chunk: int = CHUNK, floor: int = MIN_CHUNK):
    """Split n items into power-of-two dispatch sizes: full CHUNKs, then a greedy
    binary decomposition of the remainder down to ``floor``, then one tail
    (padded up to ``floor`` by the dispatchers below).

    ``floor`` bounds the program-count/padding trade: each distinct dispatch
    size is a separately compiled executable.  When the caller raises ``floor`` above the default
    (high-volume light kernels), the tail also pads to ``floor`` and the
    compiled-shape set is EXACTLY the ladder {chunk, chunk/2, ..., floor} —
    e.g. floor=chunk//8 gives at most 4 shapes — at a cost of < floor items
    of wasted device compute per batch.  At the default floor the tail uses
    pow2 buckets >= MIN_BUCKET (several more shapes, but no floor-x padding
    for heavy per-item kernels at small batch sizes)."""
    sizes = []
    while n >= chunk:
        sizes.append(chunk)
        n -= chunk
    size = chunk >> 1
    while size >= floor:
        if n >= size:
            sizes.append(size)
            n -= size
        size >>= 1
    if n > 0:
        sizes.append(n)  # bucket-padded by pad_items
    return sizes


class Pending:
    """Deferred fetch of async dispatches: ``.get()`` blocks, transfers, and
    concatenates.  Lets callers dispatch several independent kernel groups
    before waiting on any of them, so host work and transfers overlap device
    work."""

    def __init__(self, fn):
        self._fn = fn
        self._res = None
        self._done = False

    def get(self):
        if not self._done:
            self._res = self._fn()
            self._done = True
        return self._res


def chunked_indices(call, n_items: int, chunk: int = CHUNK,
                    item_div: int = 1, fetch: bool = True,
                    parallel_compile: bool = False):
    """Like ``chunked_batch`` but with NO per-item host arrays at all: the
    device program generates its own item indices.  ``call(start, n)`` must
    run items ``start .. start+n`` (n is a static power of two; indices past
    ``n_items`` are padding whose results are sliced off).  Used by the
    expanded lookup kernels so multi-million-item work lists cost zero H2D
    upload (the item fields are derived on device from per-pattern tables).

    ``item_div``: outputs whose leading axis is n/item_div (bit-packed
    results; only the final chunk may be a non-multiple, its tail padding
    lives inside the last packed word and is sliced off by the caller)."""
    import jax

    floor = max(chunk // 8, MIN_CHUNK)
    plan = []
    s = 0
    for ni in chunk_plan(n_items, chunk, floor):
        n_call = ni if (ni & (ni - 1)) == 0 and ni >= floor \
            else max(bucket_size(ni), floor)
        plan.append((s, n_call, ni))
        s += ni
    results = [None] * len(plan)
    if parallel_compile and PARALLEL_COMPILE_OK and len(plan) > 1:
        first_of_size = {}
        for i, (_, n_call, _) in enumerate(plan):
            first_of_size.setdefault(n_call, i)
        if len(first_of_size) > 1:
            futs = [(i, compile_pool().submit(call, plan[i][0], plan[i][1]))
                    for i in first_of_size.values()]
            for i, f in futs:
                results[i] = f.result()
    for i, (st, n_call, _) in enumerate(plan):
        if results[i] is None:
            results[i] = call(st, n_call)
    pending = [(results[i], plan[i][2]) for i in range(len(plan))]
    def _finish():
        if not pending:
            return None
        # ONE device_get over every chunk's outputs: all D2H copies start
        # async before any blocks, so the per-chunk transfers overlap instead
        # of serializing
        fetched = jax.device_get([res for res, _ in pending])
        parts = [[np.asarray(x)[: -(-ni // item_div)] for x in res]
                 for res, (_, ni) in zip(fetched, pending)]
        return [np.concatenate(cols) for cols in zip(*parts)]
    return _finish() if fetch else Pending(_finish)


def chunked_batch(call, arrays, chunk: int = CHUNK, fetch: bool = True,
                  item_div: int = 1, floor: int = MIN_CHUNK,
                  parallel_compile: bool = False):
    """Run ``call(*padded_arrays) -> tuple/list of outputs with leading item axis``
    over pow2-sized chunks of the item axis; returns concatenated outputs sliced
    to the real length.  Dispatches are asynchronous (fetched together at the end),
    so per-dispatch round-trip latency overlaps with device compute.

    ``item_div``: outputs whose leading axis is n/item_div (bit-packed results;
    every non-final chunk is a pow2 multiple of item_div, so only the final
    chunk's packed tail holds padding bits, sliced off by the caller).

    ``parallel_compile``: dispatch the FIRST chunk of each distinct padded size
    from the shared compile pool so first-time program compiles/loads overlap
    (see ``compile_pool``).  Only safe for
    single-device programs — collective (sharded/multi-process) dispatch must
    stay in deterministic program order on every process, so those callers
    leave this off."""
    import jax

    n = len(arrays[0])
    pieces = []
    s = 0
    # High-volume light kernels (floor raised above the default) pad their
    # tail up to the floor: the compiled-shape set is then exactly the ladder
    # {chunk..floor}.  The default floor keeps pow2 tail buckets (heavy
    # per-item kernels at small batch sizes shouldn't pay floor-x padding).
    tail_floor = floor if floor > MIN_CHUNK else 0
    for ni in chunk_plan(n, chunk, floor):
        piece = [a[s:s + ni] for a in arrays]
        s += ni
        _, *padded = pad_items(*piece, floor=tail_floor)
        pieces.append((padded, ni))
    results = [None] * len(pieces)
    if parallel_compile and PARALLEL_COMPILE_OK and len(pieces) > 1:
        first_of_size = {}
        for i, (padded, _) in enumerate(pieces):
            first_of_size.setdefault(len(padded[0]), i)
        if len(first_of_size) > 1:
            futs = [(i, compile_pool().submit(call, *pieces[i][0]))
                    for i in first_of_size.values()]
            for i, f in futs:
                results[i] = f.result()
    for i, (padded, _) in enumerate(pieces):
        if results[i] is None:
            results[i] = call(*padded)    # async dispatch; fetch later
    pending = [(results[i], pieces[i][1]) for i in range(len(pieces))]

    def _finish():
        if not pending:
            return None
        # one device_get over all chunks: D2H copies overlap (see
        # chunked_indices._finish)
        fetched = jax.device_get([res for res, _ in pending])
        parts = [[np.asarray(x)[: -(-ni // item_div)] for x in res]
                 for res, (_, ni) in zip(fetched, pending)]
        return [np.concatenate(cols) for cols in zip(*parts)]
    return _finish() if fetch else Pending(_finish)
