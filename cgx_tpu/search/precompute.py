"""Device frequent-pair precomputation.

Vectorized reformulation of the precomp kernel (GappyLook.cu:740-869) + host driver
(SuffixArray.cu:1132-1340).  The reference scans, for every (a, b) cell of the top-P
frequent tokens, the rarer token's occurrences — re-reading each occurrence up to P
times.  Here every occurrence of a top token is scanned **once** per direction; each
move yields at most one partner token, and cell membership/ownership is resolved on
the host with a binary search into the sorted top list:

* forward scan from an occurrence of ``a``: partner ``b = str[pos]`` owns cell
  (a, b) iff count(b) >= count(a)  (the reference's ``reverse`` rule,
  SuffixArray.cu:1203-1215);
* backward scan from an occurrence of ``b``: partner ``a`` owns cell (a, b) iff
  count(a) > count(b).

Gap-consistency failures are tallied per cell in ``feature_missing``
(ExtractPair.c:899-908 correction).  Emissions are identical to the reference's
per-cell scans; tests enforce bit-equality with the sequential oracle."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cgx_tpu.utils import aot
import numpy as np

from cgx_tpu.config import ExtractorConfig, check_capacity
from cgx_tpu.preproc.corpus import SourceCorpus
from cgx_tpu.preproc.suffix_array import SAIndex
from cgx_tpu.search.lookup import MMOV, _gap_check_grow
from cgx_tpu.types import Precomp
from cgx_tpu.utils.batching import chunked_batch


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "fwd"))
def _gc_batch(rlp, lr_tar, gostart, offs, mrs, mgs, fwd):
    """Gap checks for all MMOV moves of each occurrence, PACKED one uint32
    bitmask per occurrence (4 B/item D2H instead of the [n, MMOV] bool's
    16 B — the two-phase gap check fetches ~700k anchors at large512); the
    token scan, membership, and ownership tests run on the host (numpy) so
    only occurrences that own at least one cell candidate reach the device.
    Decode with ``gc_bit``."""
    from cgx_tpu.utils.views import make_views
    _, rlp, lr_tar = make_views(rlp, rlp, lr_tar, offs)
    anchor = gostart + 1 if fwd else gostart - 1
    f = functools.partial(_gap_check_grow, rlp, lr_tar)
    gc = jax.vmap(lambda a: f(a, mgs - 1, mrs, fwd))(anchor)
    bits = jnp.arange(MMOV, dtype=jnp.uint32)
    return jnp.sum(gc.astype(jnp.uint32) << bits[None, :], axis=1,
                   dtype=jnp.uint32)


def gc_bit(gc_words, mm) -> np.ndarray:
    """Host decode of _gc_batch's packed masks: move ``mm[i]``'s bit of
    occurrence i."""
    return ((np.asarray(gc_words, np.uint32) >> np.asarray(mm)) & 1) == 1


def _host_scan(refstr, tokens, counts, tok_idx, gostart, mrs, mgs, fwd):
    """Vectorized host transcription of the per-occurrence partner scan
    (GappyLook.cu:787-822 fwd / :824-861 bwd): partner token per move, sequential
    early-exit (prefix-AND), top-list membership, and cell ownership."""
    n = len(gostart)
    P = len(tokens)
    moves = np.arange(MMOV)
    if fwd:
        pos = gostart[:, None] + 1 + mgs + moves[None, :]
        # mask past-the-end reads (else they clamp to the sentinel, which is
        # >= 2 and would keep a scan alive that the reference stops)
        oob = pos >= len(refstr)
        gap0_bad = (gostart + mgs >= len(refstr)) | \
            (refstr[np.minimum(gostart + mgs, len(refstr) - 1)] < 2)
    else:
        pos = gostart[:, None] - 1 - mgs - moves[None, :]
        oob = pos < 0
        gap0_bad = (gostart - mgs >= 0) & \
            (refstr[np.maximum(gostart - mgs, 0)] < 2)
    temp = np.where(oob, -1, refstr[np.clip(pos, 0, len(refstr) - 1)])
    bad = temp < 2
    reach = np.ones((n, MMOV), dtype=bool)
    reach[:, 1:] = np.cumprod(~bad[:, :-1], axis=1).astype(bool)
    span_ok = 1 + mgs + moves + 1 <= mrs
    scan_ok = reach & ~bad & span_ok[None, :] & ~gap0_bad[:, None]
    ib = np.searchsorted(tokens, temp)
    member = (ib < P) & (tokens[np.minimum(ib, P - 1)] == temp)
    cnt_p = counts[np.minimum(ib, P - 1)]
    mine = counts[tok_idx][:, None]
    if fwd:
        owns = scan_ok & member & (cnt_p >= mine)
        cell = tok_idx[:, None] * P + ib
    else:
        owns = scan_ok & member & (cnt_p > mine)
        cell = ib * P + tok_idx[:, None]
    if fwd:
        start = np.broadcast_to(gostart[:, None], (n, MMOV))
    else:
        start = pos
    length = np.broadcast_to(moves + 1 + mgs, (n, MMOV))
    return owns, cell, start, length


def top_tokens(source: SourceCorpus, sa: SAIndex, cfg: ExtractorConfig):
    """Top-P frequent tokens via SA runs (SuffixArray.cu:1148-1198), canonical
    tie-break by ascending token id (DESIGN.md)."""
    first = np.asarray(source.str_)[np.asarray(sa.sa)]
    valid = first >= 2
    v = first[valid]
    pos = np.flatnonzero(valid)
    change = np.empty(len(v), dtype=bool)
    change[0] = True
    change[1:] = v[1:] != v[:-1]
    starts = np.flatnonzero(change)
    tokens = v[starts]
    counts = np.diff(np.concatenate([starts, [len(v)]]))
    run_start = pos[starts]
    P = min(cfg.precompute_count, len(tokens))
    order = np.argsort(-counts, kind="stable")[:P]
    order = order[np.argsort(tokens[order], kind="stable")]
    return tokens[order], counts[order], run_start[order]


def precompute_tpu(index, source: SourceCorpus, sa: SAIndex,
                   cfg: ExtractorConfig, engine=None) -> Precomp:
    """``engine`` (cgx_tpu.engine protocol) dispatches the gap-check stage;
    when given, ``index`` may be None — sharded-index builds run the checks
    owner-computes on the mesh and never touch a replicated device index."""
    tokens, counts, run_start = top_tokens(source, sa, cfg)
    P = len(tokens)
    mrs, mgs = cfg.max_rule_span, cfg.min_gap_size
    sa_host = np.asarray(sa.sa)

    # every occurrence of every top token, once
    tok_idx = np.repeat(np.arange(P), counts)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tx = np.arange(int(counts.sum())) - np.repeat(offs, counts)
    gostart = sa_host[np.repeat(run_start, counts) + tx].astype(np.int32)

    refstr_host = np.asarray(source.str_)
    rows_parts = []
    missing = np.zeros(P * P, dtype=np.int32)
    # dispatch BOTH directions before fetching either: the two gap-check
    # programs are independent, so their first-time compiles/loads and their
    # transfers overlap.  On the replicated layout the dispatch calls
    # themselves run on the compile pool; the sharded engine's programs are
    # collectives, so its dispatch order stays fwd-then-bwd inline (identical
    # on every process).
    from cgx_tpu.utils.batching import PARALLEL_COMPILE_OK
    par = (engine is None
           or getattr(engine, "parallel_dispatch_safe", False)) \
        and PARALLEL_COMPILE_OK
    jobs = []
    for fwd in (True, False):
        owns, cell, start, length = _host_scan(
            refstr_host, tokens, counts, tok_idx, gostart.astype(np.int64),
            mrs, mgs, fwd)
        live = np.flatnonzero(owns.any(axis=1))
        if not len(live):
            continue
        if engine is not None:
            disp = (lambda fwd=fwd, live=live:
                    engine.gap_check(gostart[live], fwd, fetch=False))
        else:
            disp = (lambda fwd=fwd, live=live: chunked_batch(
                lambda g: (_gc_batch(index.rlp, index.lr_tar, jnp.asarray(g),
                                     index.offs0, mrs, mgs, fwd),),
                [gostart[live]], fetch=False, parallel_compile=True))
        if par:
            from cgx_tpu.utils.batching import compile_pool
            pend = compile_pool().submit(disp)
        else:
            pend = disp()
        jobs.append((owns, cell, start, length, live, pend))
    for owns, cell, start, length, live, pend in jobs:
        if par:
            pend = pend.result()
        gc = pend.get()[0]
        ii_l, mm = np.nonzero(owns[live])
        ii = live[ii_l]
        hit = gc_bit(np.asarray(gc)[ii_l], mm)
        np.add.at(missing, cell[ii, mm][~hit], 1)
        if hit.any():
            rows_parts.append(np.stack([
                cell[ii, mm][hit], start[ii, mm][hit].astype(np.int64),
                length[ii, mm][hit].astype(np.int64)], axis=1))

    if rows_parts:
        rows = np.concatenate(rows_parts, axis=0)
        check_capacity("precomp", len(rows), cfg.cap_precomp)
        order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
        rows = rows[order]
    else:
        rows = np.empty((0, 3), dtype=np.int64)

    index_start = np.ones(P * P, dtype=np.int32)
    index_end = np.zeros(P * P, dtype=np.int32)
    if len(rows):
        uniq, first_idx, cnts = np.unique(rows[:, 0], return_index=True,
                                          return_counts=True)
        index_start[uniq] = first_idx.astype(np.int32)
        index_end[uniq] = (first_idx + cnts - 1).astype(np.int32)
    return Precomp(
        frequent_list=tokens.astype(np.int32),
        tok_start=run_start.astype(np.int32),
        tok_len=counts.astype(np.int32),
        index_start=index_start, index_end=index_end,
        onegap_start=rows[:, 1].astype(np.int32),
        onegap_length=rows[:, 2].astype(np.int32),
        feature_missing=missing, count=len(rows))
