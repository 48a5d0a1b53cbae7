"""Device gappy-pattern SA lookups.

Vectorized transcription of oneGapLookUpSA (GappyLook.cu:128-473), twoGapLookUpSA
(GappyLook.cu:476-737) and the frequent-pair precompute kernel (GappyLook.cu:740-869).

Instead of the reference's divergent per-thread ``while(flager)`` scans, each work
item (pattern-occurrence) evaluates **all** gap sizes as a static ``MMOV``-wide move
axis: per-move kill conditions are combined with a prefix-AND (``cumprod``) to
reproduce the sequential early-exit semantics exactly, and emissions come back as
dense (valid, fields...) slots.  Canonical ordering (DESIGN.md) is restored on the
host by a stable lexsort on (position, str_position, length[, length2]) — provably
equal to sequential emission order because ties share a work item and are emitted in
ascending move order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cgx_tpu.utils import aot
import numpy as np

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.types import GapOnSA, OneGapSearch, Precomp, TwoGapSearch
from cgx_tpu.engine import expand_hits
from cgx_tpu.utils.batching import chunked_batch
from cgx_tpu.utils.views import make_views

MMOV = 16  # static move-axis width; real moves bounded by max_rule_span - 2


def _fused_gapcheck() -> bool:
    """Gap-check policy: fused (the scans check the target-side gap
    themselves) unless ``CGX_FUSED_GAPCHECK=0`` selects two-phase (the scans
    emit candidates and a second dispatch gap-checks only the hits).  Both
    give the same bytes.  On an H100 at the europarl size the two were within
    run-to-run noise, fused ahead on the median, and fused compiles fewer
    programs (PERF.md, Findings)."""
    import os
    return os.environ.get("CGX_FUSED_GAPCHECK", "1") != "0"


def _mask_hits(mask, nbits=MMOV):
    """(item, move) indices of the set bits of a packed per-item bitmask —
    np.unpackbits over the little-endian byte view (one byte-wide pass)
    instead of a [N, nbits] int64 shift table."""
    m = np.ascontiguousarray(np.asarray(mask, np.uint32))
    bits = np.unpackbits(m.view(np.uint8).reshape(len(m), 4),
                         axis=1, bitorder="little")[:, :nbits]
    return np.nonzero(bits)


def _prefix_ok(survive):
    """reach[m] = AND of survive[0..m-1] (sequential early-exit emulation)."""
    c = jnp.cumprod(survive.astype(jnp.int32))
    return jnp.concatenate([jnp.ones((1,), jnp.int32), c[:-1]]) == 1


# ---------------------------------------------------------------------------
# forward / backward aXb occurrence scans (GappyLook.cu:335-470)
# ---------------------------------------------------------------------------

def _fwd_item(refstr, rlp, lr_tar, mrs, mgs, do_gap,
              gostart, sl, el, b0, b1, b2):
    """Forward scan from an occurrence of a: emissions over the move axis.
    ``b0/b1/b2`` are the first three b tokens, resolved by the caller (host
    columns for the replicated engine, qtokens gathers in the sharded
    wrappers) so the kernel itself gathers no query tokens.
    Returns a packed valid bitmask; str_position is gostart.

    ``do_gap=False`` skips the target-side gap check (rlp + lr_tar windows,
    ~33 of the item's ~60 gathered words): the orchestrator re-checks the
    surviving candidates in a tiny second dispatch (engine.gap_check) —
    hits are orders of magnitude rarer than scan items, so two-phase
    filtering halves the dominant gather volume.  ``valid = cand & gc`` with
    gc independent of the scan state, so the split is exact by construction."""
    moves = jnp.arange(MMOV, dtype=jnp.int32)
    b_first = b0
    gap0_bad = refstr[gostart + sl] < 2
    # one (MMOV+2)-wide window serves the scan and both tail-verify shifts
    wpos = gostart + sl + mgs + jnp.arange(MMOV + 2, dtype=jnp.int32)
    win = refstr[jnp.minimum(wpos, refstr.shape[0] - 1)]
    temp = win[:MMOV]
    bad = temp < 2
    # span gate for entering iteration m: sl + mgs + m + el <= mrs
    span_ok = sl + mgs + moves + el <= mrs
    # tail verify (b tokens beyond the first; el <= 3 so k in {1, 2})
    verify_ok = jnp.ones(MMOV, dtype=bool)
    verify_kill = jnp.zeros(MMOV, dtype=bool)
    is_b = temp == b_first
    for k, want in ((1, b1), (2, b2)):
        need = el > k
        in_span = sl + mgs + moves + 1 + k <= mrs
        bo = win[k:MMOV + k]
        match_k = bo == want
        # previous tail tokens all matched => this k is actually compared
        prev_ok = verify_ok
        cmp_here = is_b & need & prev_ok & in_span
        verify_ok = verify_ok & jnp.where(need, in_span & match_k, True)
        verify_kill = verify_kill | (cmp_here & ~match_k & (bo < 2))
    survive = ~bad & ~verify_kill
    reach = _prefix_ok(survive) & span_ok & ~gap0_bad
    cand = reach & ~bad & is_b & verify_ok
    valid = cand
    if do_gap:
        gc = _gap_check_grow(rlp, lr_tar, gostart + sl, mgs - 1, mrs, True)
        valid = cand & gc
    # one packed bitmask per item: emission fields (length) are pure functions
    # of (item, move) and are recomputed on the host — D2H shrinks from
    # (1+4)*MMOV to 4 bytes per item
    return (jnp.sum(jnp.where(valid, jnp.int32(1) << moves, 0)),)


def _bwd_item(refstr, rlp, lr_tar, mrs, mgs, do_gap,
              gostart, sl, el, a0, a1, a2):
    """Backward scan from an occurrence of b (GappyLook.cu:397-470).
    ``a0/a1/a2`` are the last three a tokens in reverse order
    (caller-resolved, like _fwd_item's b tokens)."""
    moves = jnp.arange(MMOV, dtype=jnp.int32)
    a_last = a0
    gap0_bad = refstr[jnp.maximum(gostart - 1, 0)] < 2
    # one reversed (MMOV+2)-wide window serves the scan and both verify
    # shifts.  Gather ASCENDING positions and flip the static vector in
    # registers, so both scan directions issue the same ascending gather.
    asc = gostart - 1 - mgs - jnp.int32(MMOV + 1) \
        + jnp.arange(MMOV + 2, dtype=jnp.int32)
    win = jnp.where(asc < 0, jnp.int32(-1),
                    refstr[jnp.maximum(asc, 0)])[::-1]
    temp = win[:MMOV]
    bad = temp < 2
    span_ok = sl + mgs + moves + el <= mrs
    verify_ok = jnp.ones(MMOV, dtype=bool)
    verify_kill = jnp.zeros(MMOV, dtype=bool)
    is_a = temp == a_last
    for k, want in ((1, a1), (2, a2)):
        need = sl > k
        in_span = el + mgs + moves + 1 + k <= mrs
        bo = win[k:MMOV + k]
        match_k = bo == want
        prev_ok = verify_ok
        cmp_here = is_a & need & prev_ok & in_span
        verify_ok = verify_ok & jnp.where(need, in_span & match_k, True)
        verify_kill = verify_kill | (cmp_here & ~match_k & (bo < 2))
    survive = ~bad & ~verify_kill
    reach = _prefix_ok(survive) & span_ok & ~gap0_bad
    cand = reach & ~bad & is_a & verify_ok
    valid = cand
    if do_gap:
        gc = _gap_check_grow(rlp, lr_tar, gostart - 1, mgs - 1, mrs, False)
        valid = cand & gc
    # packed bitmask; str_position/length recomputed host-side (see _fwd_item)
    return (jnp.sum(jnp.where(valid, jnp.int32(1) << moves, 0)),)


def _pcs_item(refstr, mrs, pstart, plen, sl, el, pa1, pa2, pb2, pb3):
    """Precomp-seeded verification of an extended aXb (GappyLook.cu:289-334):
    check span budget, the extra a prefix backwards, the extra b suffix
    forwards.  ``pa1/pa2`` (prefix) and ``pb2/pb3`` (suffix) are the query
    tokens compared at each unrolled step, caller-resolved — the kernel reads
    only 4 corpus words per item."""
    ok = plen + 1 + sl - 1 + el - 1 <= mrs
    # prefix: backoff = 1..sl-1 (sl <= 3 so unroll 1, 2)
    for k, want in ((1, pa1), (2, pa2)):
        need = sl > k
        p = pstart - k
        good = (p >= 0) & (refstr[jnp.maximum(p, 0)] == want)
        ok = ok & jnp.where(need, good, True)
    # suffix: forward = 2..el
    for k, want in ((2, pb2), (3, pb3)):
        need = el >= k
        good = refstr[pstart + plen + k - 1] == want
        ok = ok & jnp.where(need, good, True)
    return (ok,)   # str_position/length are host-derivable from the item


def _qtok_fwd(qtokens, stok):
    """First three b tokens for the forward scan (device-side resolution
    for the sharded wrappers)."""
    return qtokens[stok], qtokens[stok + 1], qtokens[stok + 2]


def _qtok_bwd(qtokens, tok, sl):
    """Last three a tokens, innermost first, for the backward scan."""
    return (qtokens[tok + sl - 1], qtokens[tok + jnp.maximum(sl - 2, 0)],
            qtokens[tok + jnp.maximum(sl - 3, 0)])


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "do_gap"))
def _fwd_batch(refstr, rlp, lr_tar, qtokens, gostart, sl, el, stok,
               offs, mrs, mgs, do_gap=True):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_fwd_item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    b0, b1, b2 = _qtok_fwd(qtokens, stok)
    return jax.vmap(f)(gostart, sl, el, b0, b1, b2)


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "do_gap"))
def _bwd_batch(refstr, rlp, lr_tar, qtokens, gostart, sl, el, tok,
               offs, mrs, mgs, do_gap=True):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_bwd_item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    a0, a1, a2 = _qtok_bwd(qtokens, tok, sl)
    return jax.vmap(f)(gostart, sl, el, a0, a1, a2)


@functools.partial(aot.jit, static_argnames=("mrs",))
def _pcs_batch(refstr, qtokens, pstart, plen, sl, el, tok, stok, offs, mrs):
    refstr, _, _ = make_views(refstr, refstr, refstr, offs)
    f = functools.partial(_pcs_item, refstr, mrs)
    pa1 = qtokens[tok + jnp.maximum(sl - 2, 0)]
    pa2 = qtokens[tok + jnp.maximum(sl - 3, 0)]
    return jax.vmap(f)(pstart, plen, sl, el, pa1, pa2,
                       qtokens[stok + 1], qtokens[stok + 2])


# ---------------------------------------------------------------------------
# column-dispatch kernels (CGX_SCAN_COLS A/B path of the replicated engine):
# the engine materializes the work-item list on the HOST (np.repeat over
# per-pattern counts) and uploads exactly the per-item columns each kernel
# needs, with query tokens already resolved — 16-24 B/item of H2D in place of
# deriving the items on device.
# ---------------------------------------------------------------------------

@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "fwd", "do_gap"))
def _scan_batch_cols(refstr, rlp, lr_tar, gostart, sl, el, w0, w1, w2,
                     offs, mrs, mgs, fwd, do_gap=True):
    """Forward/backward scans over host-resolved per-item columns; ``w*`` are
    the compared query tokens (b tokens fwd, reversed a tokens bwd)."""
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    item = _fwd_item if fwd else _bwd_item
    f = functools.partial(item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    return jax.vmap(f)(gostart, sl, el, w0, w1, w2)


@functools.partial(aot.jit, static_argnames=("mrs",))
def _pcs_batch_cols(refstr, pstart, plen, sl, el, pa1, pa2, pb2, pb3,
                    offs, mrs):
    """Precomp-seed verification over host-resolved columns, bit-packed out:
    32 items per word — the ok flags are the whole result, so D2H is n/32."""
    refstr, _, _ = make_views(refstr, refstr, refstr, offs)
    f = functools.partial(_pcs_item, refstr, mrs)
    (ok,) = jax.vmap(f)(pstart, plen, sl, el, pa1, pa2, pb2, pb3)
    bits = jnp.arange(32, dtype=jnp.uint32)
    return (jnp.sum(ok.reshape(-1, 32).astype(jnp.uint32) << bits[None, :],
                    axis=1, dtype=jnp.uint32),)


def _cumsum_expand(offs_pad, start, pat0, d_real, n: int):
    """item index -> (pattern, tx) for items [start, start+n) WITHOUT a
    per-item binary search: pattern boundaries inside the window scatter into
    a marks vector whose cumsum is the pattern index (pure vector ops + ONE
    gathered word per item for tx).  ``pat0`` = pattern owning item ``start``
    (host-computed scalar); padding items clamp to the last real pattern."""
    j = jnp.arange(n, dtype=jnp.int32)
    rel = offs_pad[1:] - start                   # [Dpad] boundary positions
    valid = (rel >= 1) & (rel <= n - 1)
    marks = jnp.zeros(n, jnp.int32).at[jnp.clip(rel, 0, n - 1)].add(
        valid.astype(jnp.int32))
    pat = jnp.clip(pat0 + jnp.cumsum(marks), 0, d_real - 1)
    tx = start + j - offs_pad[pat]
    return pat, tx


@functools.partial(aot.jit, static_argnames=("mrs", "n"))
def _pcs_batch_exp(refstr, pcrows, pattab, offs_pad, start, pat0, d_real,
                   offs, mrs, n):
    """Precomp-seed verification with on-device item expansion: per item, one
    cumsum-expand word (tx), one [8]-row gather of per-pattern fields (pc-row
    base, sl, el and the four pre-resolved query tokens), one [2]-row gather
    of the precomp occurrence (start, len), and _pcs_item's 4 corpus words —
    ~15 gathered words/item, with H2D per dispatch only O(patterns)."""
    refstr, _, _ = make_views(refstr, refstr, refstr, offs)
    pat, tx = _cumsum_expand(offs_pad, start, pat0, d_real, n)
    f = pattab[pat]                              # [n, 8]
    row = jnp.clip(f[:, 0] + tx, 0, pcrows.shape[0] - 1)
    pr = pcrows[row]                             # [n, 2] (start, len)
    ff = functools.partial(_pcs_item, refstr, mrs)
    (ok,) = jax.vmap(ff)(pr[:, 0], pr[:, 1], f[:, 1], f[:, 2], f[:, 3],
                         f[:, 4], f[:, 5], f[:, 6])
    bits = jnp.arange(32, dtype=jnp.uint32)
    return (jnp.sum(ok.reshape(-1, 32).astype(jnp.uint32) << bits[None, :],
                    axis=1, dtype=jnp.uint32),)


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "fwd", "n",
                                              "do_gap"))
def _scan_batch_exp(refstr, rlp, lr_tar, sa, pattab, offs_pad, start, pat0,
                    d_real, offs, mrs, mgs, fwd, n, do_gap=True):
    """Forward/backward scans with on-device item expansion: per item one
    cumsum-expand word (tx), one [8]-row gather of per-pattern fields
    (SA-range lo, sl, el, the three pre-resolved query tokens), one gather of
    the device-resident SA for gostart, and the item kernel's own corpus
    windows — H2D per dispatch is O(patterns), not O(items) (the column
    variant ships 24 B/item)."""
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    pat, tx = _cumsum_expand(offs_pad, start, pat0, d_real, n)
    f = pattab[pat]                              # [n, 8]
    row = jnp.clip(f[:, 0] + tx, 0, sa.shape[0] - 1)
    gostart = sa[row]
    item = _fwd_item if fwd else _bwd_item
    ff = functools.partial(item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    return jax.vmap(ff)(gostart, f[:, 1], f[:, 2], f[:, 3], f[:, 4], f[:, 5])


def one_gap_lookup_tpu(index, sa_host: np.ndarray, queries, p1, p2,
                       search: OneGapSearch, pc: Precomp,
                       cfg: ExtractorConfig, engine=None) -> GapOnSA:
    """Host orchestration + device scans; fills search.start/end_on_salist.
    ``engine`` selects the dispatch/index layout (cgx_tpu.engine); by default
    the replicated single-device layout over ``index``/``sa_host``."""
    from cgx_tpu.utils.timing import StageMarks
    mk = StageMarks("lookup1")
    if engine is None:
        from cgx_tpu.engine import ReplicatedEngine
        engine = ReplicatedEngine(index, sa_host, cfg)
    D = len(search.qrystart)
    mrs, mgs = cfg.max_rule_span, cfg.min_gap_size
    qtok = np.asarray(queries.tokens)
    sl_all = search.qrystart_len.astype(np.int64)
    el_all = search.qryend_len.astype(np.int64)
    tok_all = search.qrystart.astype(np.int64)
    stok_all = tok_all + search.gap.astype(np.int64) + sl_all

    # precomp cell per pattern (existPrecomputation)
    a_last = qtok[tok_all + sl_all - 1]
    b_first = qtok[stok_all]
    ia = np.searchsorted(pc.frequent_list, a_last)
    ib = np.searchsorted(pc.frequent_list, b_first)
    P = pc.P
    ok_a = (ia < P) & (pc.frequent_list[np.minimum(ia, P - 1)] == a_last)
    ok_b = (ib < P) & (pc.frequent_list[np.minimum(ib, P - 1)] == b_first)
    pci = np.where(ok_a & ok_b, ia * P + ib, -1)

    # ranges for non-precomp patterns
    p2_up = p2.up if len(p2.up) else np.zeros(1, np.int32)
    p2_down = p2.down if len(p2.down) else np.zeros(1, np.int32)

    def rng(tk, ln):
        u = np.where(ln == 1, p1.up[tk], 0)
        d = np.where(ln == 1, p1.down[tk], 0)
        cc = np.where(ln > 1, p2.connectoffset[tk] + ln - 2, 0)
        u = np.where(ln == 1, u, p2_up[cc])
        d = np.where(ln == 1, d, p2_down[cc])
        return u.astype(np.int64), d.astype(np.int64)

    r1u, r1d = rng(tok_all, sl_all)
    r2u, r2d = rng(stok_all, el_all)
    dis1 = r1d - r1u
    dis2 = r2d - r2u
    use_fwd = dis1 <= dis2
    has_pc = pci != -1
    pc_dis = np.where(has_pc,
                      pc.index_end[np.maximum(pci, 0)]
                      - pc.index_start[np.maximum(pci, 0)], -1)
    pc_ref = has_pc & (sl_all == 1) & (el_all == 1) & (pc_dis >= 0)
    pc_seed = has_pc & ~pc_ref

    # Cell-vs-interval routing (round 5): a pc_seed pattern's precomp cell
    # lists ALL co-occurrences of the frequent (a_last, b_first) PAIR, while
    # the full multi-token phrase is far rarer — its SA interval is usually
    # orders smaller than the cell (measured 76M pcs items at large512).
    # When both phrase intervals are valid and the cheaper one is smaller
    # than the cell, run the pattern through the SCAN path instead: the
    # scan's move axis covers every legal (gap, span) (m <= mrs-3 < MMOV)
    # and its query-time gap check evaluates the same physical gap span the
    # precompute build checked, so the emitted (pattern, spos, length) rows
    # are identical — enforced by the oracle-conformance suite.  A pattern
    # whose full phrase does not occur at all (invalid/empty interval) can
    # have no hits and skips both routes.  CGX_NO_PCS_ROUTE=1 restores the
    # always-seed behavior (A/B).
    import os as _os
    lm64 = p1.longestmatch.astype(np.int64)

    def _phrase_valid(tk, ln):
        return np.where(ln == 1, p1.up[tk] >= 0, ln <= lm64[tk])

    phrase_ok = _phrase_valid(tok_all, sl_all) \
        & _phrase_valid(stok_all, el_all) & (dis1 >= 0) & (dis2 >= 0)
    if _os.environ.get("CGX_NO_PCS_ROUTE"):
        routed = np.zeros_like(pc_seed)
    else:
        routed = pc_seed & (~phrase_ok
                            | (np.minimum(dis1, dis2) + 1 < pc_dis + 1))
    pc_seed = pc_seed & ~routed
    scan_member = ~has_pc | (routed & phrase_ok)

    mk.mark("prep")
    rows_parts = []

    # 1) precomp references: one row per pattern
    ref_ids = np.flatnonzero(pc_ref)
    if len(ref_ids):
        rows_parts.append(np.stack([
            ref_ids, pci[ref_ids], np.zeros(len(ref_ids), dtype=np.int64)], axis=1))

    # 2+3) dispatch the precomp-seed verification AND both scan directions
    # before fetching anything: the three groups are independent, so their
    # transfers overlap with each other's device work.  On the
    # replicated engine the three dispatch calls themselves run on the
    # compile pool so first-time program compiles/loads overlap too
    # (collective/sharded dispatch must stay in program order, so it's
    # inline there).
    from cgx_tpu.utils.batching import PARALLEL_COMPILE_OK
    par = getattr(engine, "parallel_dispatch_safe", False) \
        and PARALLEL_COMPILE_OK
    if par:
        from cgx_tpu.utils.batching import compile_pool
        pool = compile_pool()
    # two-phase gap filtering (CGX_FUSED_GAPCHECK=0): the scans emit
    # candidates WITHOUT the target-side gap check (cuts the rlp/lr_tar
    # windows, ~33 of ~60 gathered words/item); the surviving hits — orders
    # of magnitude rarer — re-check in a tiny second dispatch below.
    fused = _fused_gapcheck()
    seed_ids = np.flatnonzero(pc_seed)
    pcs_job = None
    if len(seed_ids):
        # Dedup identical verification jobs ACROSS patterns/queries before
        # dispatch: the ok bits depend only on (cell, sl, el, the four
        # resolved query tokens) — exactly the kernel inputs — and at
        # whole-test-set batch sizes the same frequent-pair cells recur
        # across queries (measured 76M items -> a fraction after dedup at
        # large512).  One representative pattern runs per distinct job; hits
        # broadcast back to every member pattern below.
        qpad = np.asarray(queries.padded_tokens()).astype(np.int64)
        s64, e64 = sl_all[seed_ids], el_all[seed_ids]
        t64, st64 = tok_all[seed_ids], stok_all[seed_ids]
        key = np.stack([pci[seed_ids], s64, e64,
                        qpad[t64 + np.maximum(s64 - 2, 0)],
                        qpad[t64 + np.maximum(s64 - 3, 0)],
                        qpad[st64 + 1], qpad[st64 + 2]], axis=1)
        _, rep_ix, inv = np.unique(key, axis=0, return_index=True,
                                   return_inverse=True)
        reps = seed_ids[rep_ix]
        counts_s = (pc_dis[reps] + 1).clip(min=0)
        n_orig = int((pc_dis[seed_ids] + 1).clip(min=0).sum())
        disp = lambda: engine.pcs_expanded(
            queries, pc, pc.index_start[pci[reps]].astype(np.int64),
            counts_s, sl_all[reps], el_all[reps], tok_all[reps],
            stok_all[reps], fetch=False)
        pcs_job = (counts_s, reps, inv,
                   pool.submit(disp) if par else disp())
    scan_jobs = []
    for fwd in (True, False):
        ids = np.flatnonzero(scan_member & (use_fwd == fwd))
        if not len(ids):
            continue
        lo = np.where(fwd, r1u, r2u)[ids]
        counts = (np.where(fwd, dis1, dis2)[ids] + 1).clip(min=0)
        side = (stok_all if fwd else tok_all)[ids]
        disp = (lambda fwd=fwd, lo=lo, counts=counts, ids=ids, side=side:
                engine.scan_expanded(queries, fwd, lo, counts, sl_all[ids],
                                     el_all[ids], side, fetch=False,
                                     do_gap=fused))
        scan_jobs.append((fwd, ids, lo, counts,
                          pool.submit(disp) if par else disp()))
    mk.mark("dispatch")

    if pcs_job is not None:
        counts_s, reps, inv, pend = pcs_job
        if par:
            pend = pend.result()
        (ok,) = pend.get()
        mk.mark(f"pcs_fetch[{int(counts_s.sum())}/{n_orig}]")
        hit = np.flatnonzero(np.asarray(ok, bool))
        if len(hit):
            # hits are per REPRESENTATIVE job; broadcast to every member
            # pattern of the job's dedup group (same cell + sl/el + tokens,
            # so spos/length formulas below agree per group)
            rgrp, tx, _ = expand_hits(hit, counts_s)
            hit_counts = np.bincount(rgrp, minlength=len(reps))
            gstart = np.concatenate([[0], np.cumsum(hit_counts)])[:-1]
            order = np.argsort(inv, kind="stable")
            members = seed_ids[order]
            mcounts = hit_counts[inv[order]]
            pat = np.repeat(members, mcounts)
            if len(pat):
                moffs = np.concatenate([[0], np.cumsum(mcounts)])[:-1]
                idx = (np.repeat(gstart[inv[order]], mcounts)
                       + np.arange(int(mcounts.sum()))
                       - np.repeat(moffs, mcounts))
                tx_m = tx[idx]
                row = pc.index_start[pci[pat]] + tx_m
                spos = pc.onegap_start[row].astype(np.int64) - sl_all[pat] + 1
                length = pc.onegap_length[row].astype(np.int64) \
                    + sl_all[pat] - 1 + el_all[pat] - 1
                rows_parts.append(np.stack([pat, spos, length], axis=1))
        mk.mark("pcs_post")

    hit_parts = []
    for fwd, ids, lo, counts, pend in scan_jobs:
        if par:
            pend = pend.result()
        (mask,) = pend.get()
        mk.mark(f"scan_fetch[{int(counts.sum())}]")
        ii, mm = _mask_hits(mask)
        if not len(ii):
            continue
        pat, tx, pi = expand_hits(ii, counts, ids)
        gostart = engine.sa_values(lo[pi] + tx).astype(np.int64)
        if fused:
            gcp = None
        else:
            # phase B: gap-check only the candidate hits (engine.gap_check
            # evaluates all MMOV moves of each anchor; select each hit's own
            # move below).  anchor chosen so _gc_batch's anchor+-1 lands on
            # the kernels' fixed position (gostart+sl fwd / gostart-1 bwd).
            anchor = gostart + sl_all[pat] - 1 if fwd else gostart
            gcp = engine.gap_check(anchor, fwd, fetch=False)
        hit_parts.append((fwd, pat, mm, gostart, gcp))

    for fwd, pat, mm, gostart, gcp in hit_parts:
        if gcp is not None:
            from cgx_tpu.search.precompute import gc_bit
            (gc,) = gcp.get()
            keep = gc_bit(gc, mm)
            mk.mark(f"gc_fetch[{len(mm)}->{int(keep.sum())}]")
            pat, mm, gostart = pat[keep], mm[keep], gostart[keep]
            if not len(pat):
                continue
        if fwd:
            length = sl_all[pat] + mgs + mm + el_all[pat] - 1
            rows_parts.append(np.stack([pat, gostart, length], axis=1))
        else:
            spos = gostart - 1 - mgs - mm - sl_all[pat] + 1
            length = el_all[pat] + mgs + mm + sl_all[pat] - 1
            rows_parts.append(np.stack([pat, spos, length], axis=1))

    mk.mark("scan_post")
    if rows_parts:
        rows = np.concatenate(rows_parts, axis=0)
        order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
        rows = rows[order]
    else:
        rows = np.empty((0, 3), dtype=np.int64)
    mk.mark("sort")
    mk.done()

    out = GapOnSA(position=rows[:, 0].astype(np.int32),
                  str_position=rows[:, 1].astype(np.int32),
                  length=rows[:, 2].astype(np.int32),
                  length2=np.zeros(len(rows), dtype=np.int32))
    _fill_salist(search.start_on_salist, search.end_on_salist, out.position)
    return out


def _fill_salist(start_arr, end_arr, positions):
    if len(positions):
        uniq, first, counts = np.unique(positions, return_index=True,
                                        return_counts=True)
        start_arr[uniq] = first.astype(np.int32)
        end_arr[uniq] = (first + counts - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# twoGapLookUpSA: extend each aXb core to the right looking for c
# ---------------------------------------------------------------------------

def _two_item(refstr, rlp, lr_tar, mrs, mgs, do_gap, pstart, plen):
    """Scan one aXb core rightward once; the per-pattern c-token test is hoisted
    to the host (every 2-gap pattern sharing the core sees the same scan).
    ``do_gap=False`` skips the target-side gap check (the gc half of the
    result is zeros); the orchestrator gap-checks the resolved hits in a tiny
    second dispatch — see _fwd_item."""
    moves = jnp.arange(MMOV, dtype=jnp.int32)
    gostart = pstart + plen
    gap0_bad = refstr[gostart + mgs] < 2
    pos = gostart + 1 + mgs + moves
    temp = refstr[jnp.minimum(pos, refstr.shape[0] - 1)]
    span_kill = plen + 1 + mgs + moves + 1 > mrs
    bad = temp < 2
    survive = ~bad & ~span_kill
    reach = _prefix_ok(survive) & ~gap0_bad
    cand = reach & ~span_kill & ~bad
    if do_gap:
        gc = _gap_check_grow(rlp, lr_tar, pstart + plen + 1, mgs - 1, mrs,
                             True)
        gcw = jnp.sum(jnp.where(gc, jnp.int32(1) << moves, 0))
    else:
        gcw = jnp.int32(0)
    # two packed bitmasks; the scanned c-token and length2 are recomputed on
    # the host (temp = corpus[pos] at cand hits, pos a pure item function)
    return (jnp.sum(jnp.where(cand, jnp.int32(1) << moves, 0)), gcw)


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "do_gap"))
def _two_batch(refstr, rlp, lr_tar, pstart, plen, offs, mrs, mgs,
               do_gap=True):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_two_item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    return jax.vmap(f)(pstart, plen)


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "do_gap"))
def _two_batch_packed(refstr, rlp, lr_tar, pstart, plen, offs, mrs, mgs,
                      do_gap=True):
    """_two_batch with both masks in one word (cand low 16, gc high 16):
    halves the D2H bytes per item."""
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_two_item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    cand, gc = jax.vmap(f)(pstart, plen)
    return (cand.astype(jnp.uint32) | (gc.astype(jnp.uint32) << 16),)


@functools.partial(aot.jit, static_argnames=("mrs", "mgs", "n", "do_gap"))
def _two_batch_exp(refstr, rlp, lr_tar, ogrows, pcrows, pattab, offs_pad,
                   start, pat0, d_real, offs, mrs, mgs, n, do_gap=True):
    """_two_batch_packed with on-device item expansion: per item one
    cumsum-expand word, one [2]-row gather of per-pattern fields (occurrence
    row base, pcmode), and one [2]-row gather of the (start, len) occurrence
    from the device-resident onegap results or precomp rows — H2D per
    dispatch is O(patterns) plus ONE upload of the batch's onegap occurrence
    rows (the column variant shipped 8 B/item)."""
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    pat, tx = _cumsum_expand(offs_pad, start, pat0, d_real, n)
    f = pattab[pat]                              # [n, 2]: lo, pcmode
    row = f[:, 0] + tx
    ogr = ogrows[jnp.clip(row, 0, ogrows.shape[0] - 1)]
    pcr = pcrows[jnp.clip(row, 0, pcrows.shape[0] - 1)]
    pcm = (f[:, 1] > 0)[:, None]
    sel = jnp.where(pcm, pcr, ogr)               # [n, 2] (start, len)
    ff = functools.partial(_two_item, refstr, rlp, lr_tar, mrs, mgs, do_gap)
    cand, gc = jax.vmap(ff)(sel[:, 0], sel[:, 1])
    return (cand.astype(jnp.uint32) | (gc.astype(jnp.uint32) << 16),)


def two_gap_lookup_tpu(index, queries, search1: OneGapSearch,
                       onegap_sa: GapOnSA, search2: TwoGapSearch,
                       pc: Precomp, cfg: ExtractorConfig,
                       engine=None, refstr_host: np.ndarray = None) -> GapOnSA:
    """``refstr_host``: host copy of the source token string, used to resolve
    the scanned c-token at hit positions (the device returns only bitmasks).
    Defaults to fetching from the device index once (test convenience)."""
    from cgx_tpu.extract.device import _onegap_occurrences
    if engine is None:
        from cgx_tpu.engine import ReplicatedEngine
        engine = ReplicatedEngine(index, None, cfg)
    if refstr_host is None:
        refstr_host = np.asarray(index.refstr_padded)
    D2 = len(search2.blockid)
    mrs, mgs = cfg.max_rule_span, cfg.min_gap_size
    # Scan every distinct 1-gap pattern's cores ONCE (unsampled, precomp-expanded)
    # and resolve each scan hit's c token against the 2-gap pattern set on the
    # host.  The reference re-scans the shared cores per 2-gap pattern
    # (GappyLook.cu:585-735); the emissions are identical with
    # ~|patterns-per-core|x less device work.
    # per-pattern occurrence tables (precomp-cell redirection as in
    # _onegap_occurrences); the item list itself materializes on device
    lo0 = search1.start_on_salist.astype(np.int64)
    hi0 = search1.end_on_salist.astype(np.int64)
    has = lo0 >= 0
    loc = np.clip(lo0, 0, max(len(onegap_sa.length) - 1, 0))
    if len(onegap_sa.length):
        pcmode = has & (hi0 == lo0) & (onegap_sa.length[loc] == 0)
        pci_t = onegap_sa.str_position[loc].astype(np.int64)
    else:
        pcmode = np.zeros_like(has)
        pci_t = np.zeros_like(lo0)
    pcic = np.clip(pci_t, 0, len(pc.index_start) - 1)
    lo = np.where(pcmode, pc.index_start[pcic], lo0)
    hi = np.where(pcmode, pc.index_end[pcic], hi0)
    counts = np.where(has & (hi >= lo), hi - lo + 1, 0)
    if D2 == 0 or counts.sum() == 0:
        return GapOnSA(*(np.empty(0, np.int32) for _ in range(4)))
    from cgx_tpu.utils.timing import StageMarks
    mk = StageMarks("lookup2")
    fused = _fused_gapcheck()
    cand_mask, gc_mask = engine.two_expanded(onegap_sa, pc, lo, counts,
                                             pcmode, do_gap=fused)
    mk.mark(f"scan[{int(counts.sum())}]")
    # sorted (oneId, c-token) -> twoId table; distinct patterns are unique pairs
    ctok = np.asarray(queries.tokens)[search2.gap2].astype(np.int64)
    keys = (search2.blockid.astype(np.int64) << 32) | ctok
    korder = np.argsort(keys, kind="stable")
    keys_sorted = keys[korder]
    ii, mm = _mask_hits(cand_mask)
    if not len(ii):
        return GapOnSA(*(np.empty(0, np.int32) for _ in range(4)))
    # occurrence fields + scanned c-token recomputed host-side at hits only
    pat, tx, _ = expand_hits(ii, counts)
    row = lo[pat] + tx
    pcm_i = pcmode[pat]
    og_sp = onegap_sa.str_position if len(onegap_sa.str_position) \
        else np.zeros(1, np.int32)
    og_ln = onegap_sa.length if len(onegap_sa.length) \
        else np.zeros(1, np.int32)
    pc_sp = pc.onegap_start if len(pc.onegap_start) else np.zeros(1, np.int32)
    pc_ln = pc.onegap_length if len(pc.onegap_length) \
        else np.zeros(1, np.int32)
    css = np.where(pcm_i, pc_sp[np.clip(row, 0, len(pc_sp) - 1)],
                   og_sp[np.clip(row, 0, len(og_sp) - 1)]).astype(np.int64)
    fes = np.where(pcm_i, pc_ln[np.clip(row, 0, len(pc_ln) - 1)],
                   og_ln[np.clip(row, 0, len(og_ln) - 1)]).astype(np.int64)
    pos = css + fes + 1 + mgs + mm
    temp_hit = refstr_host[np.minimum(pos, len(refstr_host) - 1)]
    want = (pat.astype(np.int64) << 32) | temp_hit.astype(np.int64)
    ki = np.searchsorted(keys_sorted, want)
    found = (ki < len(keys_sorted)) & \
        (keys_sorted[np.minimum(ki, len(keys_sorted) - 1)] == want)
    if fused:
        hit = found & (((gc_mask[ii].astype(np.int64) >> mm) & 1) == 1)
        gcp = idx = None
    else:
        # phase B: gap-check only the c-token-resolved hits (fixed position
        # of the kernel's check is css+fes+1 => pass css+fes, see _gc_batch).
        # Dispatch fetch=False so the transfer overlaps the gc-independent
        # host resolve below (two_id/length2), mirroring the one-gap
        # hit_parts pattern.
        hit = found.copy()
        idx = np.flatnonzero(found)
        gcp = engine.gap_check((css + fes)[idx], True, fetch=False) \
            if len(idx) else None
    two_id_all = korder[np.minimum(ki, len(korder) - 1)]
    length2 = fes + 1 + mgs + mm
    if gcp is not None:
        from cgx_tpu.search.precompute import gc_bit
        (gc2,) = gcp.get()
        hit[idx] &= gc_bit(gc2, mm[idx])
        mk.mark(f"gc_fetch[{len(idx)}->{int(hit.sum())}]")
    two_id = two_id_all[hit]
    rows = np.stack([two_id, css[hit], fes[hit],
                     length2[hit].astype(np.int64)], axis=1)
    order = np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))
    rows = rows[order]
    mk.mark("resolve")
    mk.done()
    out = GapOnSA(position=rows[:, 0].astype(np.int32),
                  str_position=rows[:, 1].astype(np.int32),
                  length=rows[:, 2].astype(np.int32),
                  length2=rows[:, 3].astype(np.int32))
    _fill_salist(search2.start_on_salist, search2.end_on_salist, out.position)
    return out


# ---------------------------------------------------------------------------
# Fused nested-window gap check.
#
# The per-move gap spans of every scan kernel are nested (fixed start growing
# right, or fixed end growing left), so all MMOV checkBoundaryGap evaluations
# share one RLP window: load it once, take prefix (or suffix) min/max of the
# aligned L/R spans, and evaluate every move from the scans.  The back-projection
# windows are nested too — all valid target spans fit in a 16-wide window anchored
# at the widest valid span's min — so the target side is also a single load plus a
# [MMOV, 16] masked reduction.  Equivalent to vmapping _gap_check over moves
# (garbage on moves whose spans cross sentence boundaries, which every caller
# masks out via its scan-kill logic), with ~20x less gather traffic.
# ---------------------------------------------------------------------------

def _gap_check_grow(rlp, lr_tar, fixed, base_off, mrs: int,
                    grow_right: bool):
    """ok[MMOV] for spans [fixed, fixed+base_off+m] (grow_right) or
    [fixed-base_off-m, fixed] (grow_left)."""
    moves = jnp.arange(MMOV, dtype=jnp.int32)
    w = jnp.arange(mrs, dtype=jnp.int32)
    if grow_right:
        ks = fixed + w                       # window left-aligned at fixed
    else:
        ks = fixed - w                       # reversed window ending at fixed
    temp = rlp[jnp.clip(ks, 0, rlp.shape[0] - 1)].astype(jnp.uint32)
    L = ((temp >> 24) & 0xFF).astype(jnp.int32)
    R = ((temp >> 16) & 0xFF).astype(jnp.int32)
    oob = ks < 0
    unal = (L == 255) | (R == 255) | oob
    al = ~unal
    minL_pref = jax.lax.associative_scan(jnp.minimum, jnp.where(al, L, 256))
    maxR_pref = jax.lax.associative_scan(jnp.maximum, jnp.where(al, R, -1))
    span = base_off + moves                  # outer offset of each move's span
    off = jnp.clip(span, 0, mrs - 1)
    minL = minL_pref[off]
    maxR = maxR_pref[off]
    fail0 = unal[0] | jnp.take(unal, off) | (span < 0) | (span > mrs - 1)
    # sentence anchor at each span's start token (constant within a sentence;
    # grow_right: fixed; grow_left: the innermost (m=0) start)
    if grow_right:
        start_tok = fixed
    else:
        start_tok = fixed - base_off
    t0 = rlp[jnp.clip(start_tok, 0, rlp.shape[0] - 1)].astype(jnp.uint32)
    p0 = ((t0 >> 8) & 0xFF).astype(jnp.int32)
    tempind = start_tok - p0 - 1
    stb = jnp.where(tempind == -1, jnp.int32(0),
                    rlp[jnp.clip(tempind, 0, rlp.shape[0] - 1)].astype(jnp.int32))
    ok1 = ~fail0 & (minL <= maxR) & (maxR - minL < mrs)
    ts = minL + stb
    te = maxR + stb
    # target union window: anchored at the min ts over valid moves; every valid
    # span fits within 16 positions of it (see module comment)
    anchor = jnp.min(jnp.where(ok1, ts, 2**30))
    anchor = jnp.where(anchor == 2**30, jnp.int32(0), anchor)
    win = anchor + jnp.arange(MMOV, dtype=jnp.int32)
    winc = jnp.clip(win, 0, lr_tar.shape[0] - 1)
    w2 = lr_tar[winc]
    L2 = w2 >> 8
    R2 = w2 & 255
    al2 = (L2 != 255) & (R2 != 255)
    inb = (win[None, :] >= ts[:, None]) & (win[None, :] <= te[:, None])
    m2 = inb & al2[None, :]
    bmin = jnp.min(jnp.where(m2, L2[None, :], 256), axis=1)
    bmax = jnp.max(jnp.where(m2, R2[None, :], -1), axis=1)
    if grow_right:
        src_start = jnp.broadcast_to(fixed, (MMOV,))
        src_end = fixed + span
    else:
        src_start = fixed - span
        src_end = jnp.broadcast_to(fixed, (MMOV,))
    return ok1 & (tempind + 1 + bmin == src_start) & \
        (tempind + 1 + bmax == src_end)
