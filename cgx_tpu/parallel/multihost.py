"""Multi-host execution: query sharding across processes.

The reference has no distribution (SURVEY.md section 2.3); here each host runs
the full pipeline on its own contiguous slice of the query file against a
replicated corpus index, the natural layout for per-query grammar-file output:

* coordination via ``jax.distributed.initialize`` (ICI within a slice, DCN
  across) — wired to the CLI flags ``--coordinator/--num-processes/
  --process-id``, and exercised by a REAL 2-process run in
  tests/test_multihost.py;
* the corpus index artifact is built once (process 0) and shared via the
  persisted artifact directory (``--index-dir`` on a common filesystem);
  other processes wait for the artifact and load instead of rebuilding;
* queries are split into contiguous blocks (keeps per-host output file ranges
  contiguous); each host writes only its own ``grammar.<i>.{s,n}`` files;
* global rule/line counts reduce with ``multihost_utils.process_allgather``.

Single-process fallback: with one process this degenerates to the plain
pipeline.

Composed mode (``sa_shards > 0`` with >1 process): the index shards span the
GLOBAL device set — each process addresses only its own devices' shards, so
corpora beyond one HOST's total HBM become queryable.  Queries are replicated
through the device path (the interval-refinement search is a lockstep
collective over the global mesh), device work is split by shard ownership
(each process dispatches only its local shards' work items,
``sharded.ShardedEngine._partitioned``), and the owned rows exchange with one
sum-allgather per kernel output.  Host scoring is replicated per process;
each process still writes only its contiguous slice of grammar files.  The
one-time build runs in lockstep on every process (same deterministic inputs
=> same collective sequence); only process 0 persists the artifact.
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed bootstrap; no-op when unconfigured (single host)."""
    if coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    # Split-brain guard: if JAX backends were initialized before the
    # distributed state, every process silently becomes its own 1-process
    # world — process 0's coordinator then waits forever while the others
    # compute the whole job alone.  Fail loudly instead.
    if num_processes is not None and jax.process_count() != num_processes:
        raise RuntimeError(
            f"jax.distributed.initialize connected, but the backend reports "
            f"process_count={jax.process_count()} (expected {num_processes})."
            f" JAX backends were initialized before the distributed state; "
            f"call initialize() before any other JAX use.")
    return True


def query_slice(n_queries: int, process_id: int = None,
                process_count: int = None):
    """Contiguous query range [lo, hi) owned by this host."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    per = -(-n_queries // pcount)
    lo = min(pid * per, n_queries)
    hi = min(lo + per, n_queries)
    return lo, hi


def _wait_for_artifact(index_dir: str, timeout_s: float = 600.0):
    """Non-zero processes block until process 0 has persisted the artifact
    (meta.json is written last, so its presence implies a complete artifact)."""
    deadline = time.monotonic() + timeout_s
    meta = os.path.join(index_dir, "meta.json")
    while not os.path.exists(meta):
        if time.monotonic() > deadline:
            raise TimeoutError(f"index artifact never appeared at {index_dir}")
        time.sleep(0.2)


def _phase_max_allgather(timing):
    """Per-phase MAX across processes (the critical-path view of recordTime's
    buckets, Start.cu:392-469, for a multi-host run).  Phase dicts differ in
    keys per process (e.g. builder vs artifact-loader), so they exchange as
    length-prefixed JSON byte buffers; the buffer size is agreed across
    processes with a max-allgather first, so no payload is ever truncated."""
    import json
    from jax.experimental import multihost_utils
    payload = json.dumps(timing.as_dict()).encode()
    # agree on a common buffer size (allgather needs equal shapes everywhere)
    sizes = np.asarray(multihost_utils.process_allgather(
        np.asarray([len(payload)], np.int64)))
    width = int(sizes.max())
    buf = np.zeros(8 + width, np.uint8)
    buf[:8] = np.frombuffer(np.asarray([len(payload)], np.int64).tobytes(),
                            np.uint8)
    buf[8:8 + len(payload)] = np.frombuffer(payload, np.uint8)
    rows = np.asarray(multihost_utils.process_allgather(buf)).reshape(
        -1, buf.size)
    agg: dict = {}
    for row in rows:
        n = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        text = bytes(row[8:8 + n]).decode() or "{}"
        for k, v in json.loads(text).items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return agg


def run_multihost(f_lines, e_lines, a_lines, lex_tokens, q_lines, dest_dir,
                  cfg, index_dir=None, sa_shards: int = 0,
                  dp_devices: int = 0):
    """Run the pipeline on this host's query shard; writes this host's grammar
    files with their global query indices.  Returns (lo, hi, PipelineResult,
    global_line_count).

    ``dp_devices > 1`` composes multi-host query sharding with single-process
    local DP: each process drives its M LOCAL devices through
    ``LocalDPEngine`` (``jax.local_devices()`` is per-process under
    ``jax.distributed``) while the query file splits across processes — the
    natural N-host x M-chip slice deployment with ONE process per host,
    paying interpreter + index + program-cache fixed cost once per host
    instead of once per chip.  Mutually exclusive with the composed sharded
    mode (replicated-per-device vs sharded index)."""
    from cgx_tpu import pipeline as tpl

    composed = sa_shards > 0 and jax.process_count() > 1
    if composed and dp_devices:
        raise ValueError("sa_shards and dp_devices are mutually exclusive")
    if index_dir and jax.process_index() != 0 and not composed:
        # composed mode builds in lockstep instead (collective build kernels)
        _wait_for_artifact(index_dir)
    n = len(q_lines)
    lo, hi = query_slice(n)
    run_q = q_lines if composed else q_lines[lo:hi]
    res = tpl.run_pipeline(f_lines, e_lines, a_lines, lex_tokens,
                           run_q, cfg, index_dir=index_dir,
                           sa_shards=sa_shards, dp_devices=dp_devices)
    os.makedirs(dest_dir, exist_ok=True)
    suffix = "s" if cfg.is_sample else "n"
    for q_global in range(lo, hi):
        lines = res.per_query_lines[q_global if composed else q_global - lo]
        path = os.path.join(dest_dir, f"grammar.{q_global}.{suffix}")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines))
            if lines:
                fh.write("\n")
    total_lines = res.counters["total_lines"]
    if jax.process_count() > 1:
        if not composed:
            from jax.experimental import multihost_utils
            all_counts = multihost_utils.process_allgather(
                np.asarray([total_lines], np.int64))
            total_lines = int(np.sum(all_counts))
        # per-phase critical path across ALL processes, for -s timefile
        res.timing.global_phase_max = _phase_max_allgather(res.timing)
    return lo, hi, res, total_lines
