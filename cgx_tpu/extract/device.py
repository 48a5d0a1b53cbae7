"""Device rule extraction.

Vectorized transcription of the three extraction kernels:

* extractConsistentPairs_Gappy (ExtractPair.cu:1055-1795): ab + Xab/abX/XabX growth
  per contiguous-block occurrence;
* extractConsistentPairs_OneGap (ExtractPair.cu:351-889): aXb + XaXb/aXbX per 1-gap
  pattern occurrence;
* extractConsistentPairs_TwoGap (ExtractPair.cu:891-1053): aXbXc per 2-gap occurrence.

One vmap lane per sampled occurrence; the sequential growth loops (i = 1..14) are
statically unrolled over traced scalar state that mirrors the CUDA flags
(Xab/abX/XabX/XabNoSuccess/...) exactly, with per-step quantities (prefix min/max of
alignment spans, gap/whole-span consistency) precomputed as width-IMAX arrays.
Emissions are fixed slots per lane (each rule family emits at most once per
occurrence), compacted on the host in canonical occurrence order.  Sampling
(ExtractPair.cu:1133-1160) happens host-side when the occurrence lists are built, via
the shared ``sample_indices``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cgx_tpu.utils import aot
import numpy as np

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.extract.blocks import occurrence_lists, sample_indices
from cgx_tpu.utils.batching import chunked_batch
from cgx_tpu.utils.views import make_views
from cgx_tpu.types import Blocks, ContigRules, GapOnSA, GapRules, OneGapSearch, Precomp, TwoGapSearch

IMAX = 14   # max growth distance: lm + i <= max_rule_span with lm >= 1
CWID = 16   # static width for masked span loops


def _pack_family(v, ts, te, g1s, g1e, g2s=None, g2e=None):
    """One int32 per emission slot: valid bit + 4-bit span/gap offsets relative
    to the family's target start (every emitted span has width < max_rule_span,
    enforced by the state machines' w_span kills), so each family crosses the
    wire as (ts, packed) = 8 bytes instead of 20-28."""
    def off(x, sh):
        return jnp.clip(jnp.where(v, x - ts, 0), 0, 15) << sh
    pk = v.astype(jnp.int32) | off(te, 1) | off(g1s, 5) | off(g1e, 9)
    if g2s is not None:
        pk = pk | off(g2s, 13) | off(g2e, 17)
    return ts, pk


def unpack_family(ts, pk, two_gaps=False):
    """Host inverse of _pack_family -> (v, ts, te, g1s, g1e[, g2s, g2e])."""
    pk = np.asarray(pk, np.int64)
    ts = np.asarray(ts, np.int64)
    v = (pk & 1).astype(bool)
    out = [v, ts, ts + ((pk >> 1) & 15), ts + ((pk >> 5) & 15),
           ts + ((pk >> 9) & 15)]
    if two_gaps:
        out += [ts + ((pk >> 13) & 15), ts + ((pk >> 17) & 15)]
    return tuple(out)


def _rlp_LR(rlp, pos):
    """(L, R, aligned) from an RLP word, OOB-guarded to unaligned."""
    oob = pos < 0
    t = rlp[jnp.clip(pos, 0, rlp.shape[0] - 1)].astype(jnp.uint32)
    L = ((t >> 24) & 0xFF).astype(jnp.int32)
    R = ((t >> 16) & 0xFF).astype(jnp.int32)
    L = jnp.where(oob, 255, L)
    R = jnp.where(oob, 255, R)
    return L, R, (L != 255) & (R != 255)


def _consistent_dev(lr_tar, ts, te, start_chk, end_chk, sentstart):
    """consistent() (ExtractPair.cu:103-133) over a target span <= CWID wide."""
    ks = ts + jnp.arange(CWID, dtype=jnp.int32)
    mask = ks <= te
    ksc = jnp.clip(ks, 0, lr_tar.shape[0] - 1)
    w = lr_tar[ksc]
    L = w >> 8
    R = w & 255
    al = mask & (L != 255) & (R != 255)
    bmin = jnp.min(jnp.where(al, L, 256))
    bmax = jnp.max(jnp.where(al, R, -1))
    return (sentstart + bmin == start_chk) & (sentstart + bmax == end_chk)


def _sent_anchor(rlp, pos):
    """tempind/sen_target_begin computed at a span's first token
    (ExtractPair.cu:1183-1191 et al.).  Returns (sentstart_src=tempind+1, stb)."""
    t = rlp[jnp.clip(pos, 0, rlp.shape[0] - 1)].astype(jnp.uint32)
    p = ((t >> 8) & 0xFF).astype(jnp.int32)
    tempind = pos - p - 1
    stb = jnp.where(tempind == -1, jnp.int32(0),
                    rlp[jnp.clip(tempind, 0, rlp.shape[0] - 1)].astype(jnp.int32))
    return tempind + 1, stb


def _cummin(vals, mask, init):
    x = jnp.where(mask, vals, init)
    return jax.lax.associative_scan(jnp.minimum, x)


def _cummax(vals, mask, init):
    x = jnp.where(mask, vals, init)
    return jax.lax.associative_scan(jnp.maximum, x)


def _tar_window_prefixes(lr_tar, anchor, H):
    """One (2H+1)-wide gather of l_tar/r_tar around ``anchor`` plus bidirectional
    prefix min/max scans.  Every consistency-check span consumed by the extraction
    state machines has width < max_rule_span and contains its family's anchor
    point, so range-min(L)/range-max(R) over [ts, te] decomposes into one
    backward-prefix lookup at (anchor - ts) and one forward-prefix lookup at
    (te - anchor) — replacing a fresh 16-wide gather per check (the reference
    re-reads the window inside every consistent() call, ExtractPair.cu:103-133)."""
    offs = jnp.arange(-H, H + 1, dtype=jnp.int32)
    win = anchor + offs
    winc = jnp.clip(win, 0, lr_tar.shape[0] - 1)
    w = lr_tar[winc]
    L = w >> 8
    R = w & 255
    al = (L != 255) & (R != 255)
    Lv = jnp.where(al, L, 256)
    Rv = jnp.where(al, R, -1)
    fwdL = jax.lax.associative_scan(jnp.minimum, Lv[H:])
    bwdL = jax.lax.associative_scan(jnp.minimum, Lv[:H + 1][::-1])
    fwdR = jax.lax.associative_scan(jnp.maximum, Rv[H:])
    bwdR = jax.lax.associative_scan(jnp.maximum, Rv[:H + 1][::-1])
    return fwdL, bwdL, fwdR, bwdR


def _win_check(prefixes, anchor, ts, te, start_chk, end_chk, sentstart, H):
    """consistent() over target span [ts, te] answered from anchored-window
    prefixes.  Exact for any span that contains ``anchor`` and has width <= H
    (all consumed checks); empty spans (ts > te) reproduce the reference's
    masked-reduce identity values (bmin=256, bmax=-1)."""
    fwdL, bwdL, fwdR, bwdR = prefixes
    lo = jnp.clip(anchor - ts, 0, H)
    hi = jnp.clip(te - anchor, 0, H)
    bmin = jnp.minimum(bwdL[lo], fwdL[hi])
    bmax = jnp.maximum(bwdR[lo], fwdR[hi])
    empty = ts > te
    bmin = jnp.where(empty, 256, bmin)
    bmax = jnp.where(empty, -1, bmax)
    return (sentstart + bmin == start_chk) & (sentstart + bmax == end_chk)


def _grow_side_arrays(refstr, rlp, lr_tar, base, step, sentstart, stb,
                      span_lo_fn, span_hi_fn, H):
    """Per-step arrays for one growth side: token, aligned, prefix min/max of the
    X span, and the X-gap consistency result (consistent(gap, [lo_i, hi_i])).
    The IMAX gap spans are nested (prefix min/max), all containing the first
    aligned step's (L, R) anchor, so one anchored window serves every check."""
    steps = jnp.arange(1, IMAX + 1, dtype=jnp.int32)
    pos = base + step * steps
    oob = pos < 0
    tok = jnp.where(oob, jnp.int32(-1),
                    refstr[jnp.clip(pos, 0, refstr.shape[0] - 1)])
    L, R, al = _rlp_LR(rlp, pos)
    pmin = _cummin(L, al, jnp.int32(255))
    pmax = _cummax(R, al, jnp.int32(0))

    first = jnp.argmax(al)
    anchor = stb + L[first]          # unused when no step is aligned (all empty)
    pref = _tar_window_prefixes(lr_tar, anchor, H)
    i0s = jnp.arange(IMAX, dtype=jnp.int32)
    gconsist = _win_check(pref, anchor, stb + pmin, stb + pmax,
                          span_lo_fn(i0s + 1), span_hi_fn(i0s + 1),
                          sentstart, H)
    return tok, al, pmin, pmax, gconsist


def _extract_contig_item(refstr, rlp, lr_tar, mrs, msym, cs, lm):
    """One sampled occurrence of a contiguous block (ExtractPair.cu:1147-1794)."""
    ender = cs + lm - 1
    sentstart, stb = _sent_anchor(rlp, cs)

    # base span scan (ExtractPair.cu:1178-1231)
    ks = cs + jnp.arange(CWID, dtype=jnp.int32)
    kmask = ks < cs + lm
    L0, R0, al0 = _rlp_LR(rlp, ks)
    first_un = ~al0[0]
    last_off = jnp.clip(lm - 1, 0, CWID - 1)
    last_un = ~jnp.take(al0, last_off)
    min_L = jnp.min(jnp.where(kmask & al0, L0, 256))
    max_R = jnp.max(jnp.where(kmask & al0, R0, -1))
    ab = ~first_un & ~last_un
    abXNoSuccess = ~first_un
    XabNoSuccess = ~last_un
    dead = (min_L > max_R) | (max_R - min_L >= mrs)
    ab &= ~dead
    Xab = ~dead
    abX = ~dead
    XabX = ~dead

    H = mrs - 1
    anchor = stb + jnp.minimum(min_L, 255)   # base-span anchor; dead => unused
    base_pref = _tar_window_prefixes(lr_tar, anchor, H)
    ab_ts = min_L + stb
    ab_len = max_R - min_L
    ab_ok = ab & _win_check(base_pref, anchor, ab_ts, max_R + stb,
                            cs, ender, sentstart, H)

    Xab &= lm + 1 <= msym
    abX &= lm + 1 <= msym
    XabX &= lm + 2 <= msym

    # per-step side arrays
    ltok, lal, lmin, lmax, lgap = _grow_side_arrays(
        refstr, rlp, lr_tar, cs, -1, sentstart, stb,
        lambda i: cs - i, lambda i: cs - 1, H)
    rtok, ral, rmin, rmax, rgap = _grow_side_arrays(
        refstr, rlp, lr_tar, ender, 1, sentstart, stb,
        lambda i: ender + 1, lambda i: ender + i, H)

    # Whole-span (one X) + 2D XabX consistency tables.  All these spans contain
    # the base anchor, and the window prefixes are monotone (bwdL/fwdL
    # non-increasing, bwdR/fwdR non-decreasing), so prefix[max(x, y)] factorizes:
    # the (IMAX, IMAX) XabX table reduces to two IMAX part-vectors combined with
    # an outer min/max — 196 -> 28 prefix lookups per lane, exactly equal values.
    ir = jnp.arange(IMAX, dtype=jnp.int32)
    fwdL, bwdL, fwdR, bwdR = base_pref
    loL = jnp.clip(min_L - lmin, 0, H)
    hiL = jnp.clip(jnp.maximum(lmax, max_R) - min_L, 0, H)
    loR = jnp.clip(min_L - rmin, 0, H)
    hiR = jnp.clip(jnp.maximum(rmax, max_R) - min_L, 0, H)
    mnL = jnp.minimum(bwdL[loL], fwdL[hiL])   # range-min(L) of left-whole span
    mxL = jnp.maximum(bwdR[loL], fwdR[hiL])   # range-max(R) of left-whole span
    mnR = jnp.minimum(bwdL[loR], fwdL[hiR])
    mxR = jnp.maximum(bwdR[loR], fwdR[hiR])

    wl_ts = stb + jnp.minimum(lmin, min_L)
    wl_te = stb + jnp.maximum(lmax, max_R)
    wl_ok = (sentstart + mnL == cs - (ir + 1)) & (sentstart + mxL == ender)
    wr_ts = stb + jnp.minimum(rmin, min_L)
    wr_te = stb + jnp.maximum(rmax, max_R)
    wr_ok = (sentstart + mnR == cs) & (sentstart + mxR == ender + (ir + 1))

    # a = left extent, b = right extent (1-based - 1)
    w2_ts = stb + jnp.minimum(jnp.minimum(lmin[:, None], rmin[None, :]), min_L)
    w2_te = stb + jnp.maximum(jnp.maximum(lmax[:, None], rmax[None, :]), max_R)
    bmin2 = jnp.minimum(mnL[:, None], mnR[None, :])
    bmax2 = jnp.maximum(mxL[:, None], mxR[None, :])
    w2_ok = (sentstart + bmin2 == cs - (ir[:, None] + 1)) & \
        (sentstart + bmax2 == ender + (ir[None, :] + 1))

    # sequential growth as fori_loops (mirrors ExtractPair.cu:1280-1791);
    # rolled loops keep the XLA graph small (compile time) at identical semantics
    def xabx_scan(i, xcond, XabX_in, xabx, count_limit, al_k, pmin_k, pmax_k,
                  gap_k, w_ts_k, w_te_k, w_ok_k, o_min, o_max, scan_is_left):
        """One XabX inner branch: scan extents k = 1..count_limit.
        (al_k, pmin_k, ...) are the scanned side's arrays at k; (o_min, o_max)
        the other side's fixed extent-i gap span for the emitted fields."""
        i0 = i - 1

        def body(k, st):
            alive, XabX, v, ts, te, g1s, g1e, g2s, g2e = st
            k0 = k - 1
            run = alive & (k <= count_limit) & XabX
            budget = k + i + lm <= mrs
            alive &= ~(run & ~budget)
            nx = run & budget & al_k[k0]
            spank2 = pmax_k[k0] - pmin_k[k0] >= mrs
            alive &= ~(nx & spank2)
            nx &= ~spank2
            nx &= gap_k[k0]
            w_span_bad = w_te_k[k0] - w_ts_k[k0] >= mrs
            alive &= ~(nx & w_span_bad)
            nx &= ~w_span_bad
            nx &= w_ok_k[k0]
            emit = nx & XabX
            v |= emit
            ts = jnp.where(emit, w_ts_k[k0], ts)
            te = jnp.where(emit, w_te_k[k0], te)
            # gap fields: scanned side at k, other side at i
            sg_s = stb + pmin_k[k0]
            sg_e = stb + pmax_k[k0]
            og_s = stb + o_min
            og_e = stb + o_max
            # gap1 is always the LEFT X span, gap2 the RIGHT X span
            n1s, n1e = (sg_s, sg_e) if scan_is_left else (og_s, og_e)
            n2s, n2e = (og_s, og_e) if scan_is_left else (sg_s, sg_e)
            g1s = jnp.where(emit, n1s, g1s)
            g1e = jnp.where(emit, n1e, g1e)
            g2s = jnp.where(emit, n2s, g2s)
            g2e = jnp.where(emit, n2e, g2e)
            XabX = jnp.where(emit, jnp.bool_(False), XabX)
            return (alive, XabX, v, ts, te, g1s, g1e, g2s, g2e)

        st = (xcond, XabX_in) + xabx
        st = jax.lax.fori_loop(1, IMAX + 1, body, st)
        return st[1], st[2:]

    def outer_body(i, st):
        (Xab, abX, XabX, XabNoSuccess, abXNoSuccess, XabCount, abXCount,
         xab, abx, xabx) = st
        i0 = i - 1
        F = jnp.bool_(False)
        active = (lm + i <= mrs) & (abXNoSuccess | XabNoSuccess | XabX)
        # ---- Xab (left)
        l_has = (cs - i >= 0) & (ltok[i0] >= 2)
        l_proc = active & Xab & l_has
        Xab = jnp.where(active & ~l_has, F, Xab)
        nxt = l_proc & lal[i0]
        first_unal = l_proc & ~lal[i0] & (i == 1)
        Xab = jnp.where(first_unal, F, Xab)
        XabX = jnp.where(first_unal, F, XabX)
        spank = lmax[i0] - lmin[i0] >= mrs
        Xab = jnp.where(l_proc & spank, F, Xab)
        nxt &= ~spank
        nxt &= lgap[i0]
        XabCount = jnp.where(nxt, i, XabCount)
        wkill = l_proc & XabNoSuccess & nxt & (wl_te[i0] - wl_ts[i0] >= mrs)
        Xab = jnp.where(wkill, F, Xab)
        emit = l_proc & XabNoSuccess & nxt & ~wkill & wl_ok[i0]
        xab = (xab[0] | emit,
               jnp.where(emit, wl_ts[i0], xab[1]),
               jnp.where(emit, wl_te[i0], xab[2]),
               jnp.where(emit, stb + lmin[i0], xab[3]),
               jnp.where(emit, stb + lmax[i0], xab[4]))
        XabNoSuccess = jnp.where(emit, F, XabNoSuccess)
        # ---- abX (right)
        r_has = rtok[i0] >= 2
        r_proc = active & abX & r_has
        abX = jnp.where(active & ~r_has, F, abX)
        nxt = r_proc & ral[i0]
        first_unal = r_proc & ~ral[i0] & (i == 1)
        abX = jnp.where(first_unal, F, abX)
        XabX = jnp.where(first_unal, F, XabX)
        spank = rmax[i0] - rmin[i0] >= mrs
        abX = jnp.where(r_proc & spank, F, abX)
        nxt &= ~spank
        nxt &= rgap[i0]
        abXCount = jnp.where(nxt, i, abXCount)
        wkill = r_proc & abXNoSuccess & nxt & (wr_te[i0] - wr_ts[i0] >= mrs)
        abX = jnp.where(wkill, F, abX)
        emit = r_proc & abXNoSuccess & nxt & ~wkill & wr_ok[i0]
        abx = (abx[0] | emit,
               jnp.where(emit, wr_ts[i0], abx[1]),
               jnp.where(emit, wr_te[i0], abx[2]),
               jnp.where(emit, stb + rmin[i0], abx[3]),
               jnp.where(emit, stb + rmax[i0], abx[4]))
        abXNoSuccess = jnp.where(emit, F, abXNoSuccess)
        # ---- XabX (ExtractPair.cu:1514-1777)
        xcond = active & XabX & (abX | Xab)
        # branch 1 scans the RIGHT side (left extent fixed at i)
        XabX, xabx = xabx_scan(i, xcond & (XabCount == i), XabX, xabx,
                               abXCount, ral, rmin, rmax, rgap,
                               w2_ts[i0], w2_te[i0], w2_ok[i0],
                               lmin[i0], lmax[i0], False)
        # branch 2 scans the LEFT side (right extent fixed at i)
        XabX, xabx = xabx_scan(i, xcond & XabX & (abXCount == i), XabX, xabx,
                               XabCount, lal, lmin, lmax, lgap,
                               w2_ts[:, i0], w2_te[:, i0], w2_ok[:, i0],
                               rmin[i0], rmax[i0], True)
        XabX = jnp.where(active & ~(abX | Xab), F, XabX)
        # spin sync (ExtractPair.cu:1782-1789)
        sync = active & ~XabX
        XabNoSuccess = jnp.where(sync & ~Xab, F, XabNoSuccess)
        abXNoSuccess = jnp.where(sync & ~abX, F, abXNoSuccess)
        return (Xab, abX, XabX, XabNoSuccess, abXNoSuccess, XabCount, abXCount,
                xab, abx, xabx)

    F0 = jnp.bool_(False)
    z = jnp.int32(0)
    rule5 = (F0, z, z, z, z)
    rule7 = (F0, z, z, z, z, z, z)
    st = (Xab, abX, XabX, XabNoSuccess, abXNoSuccess, jnp.int32(0),
          jnp.int32(0), rule5, rule5, rule7)
    st = jax.lax.fori_loop(1, IMAX + 1, outer_body, st)
    xab, abx, xabx = st[7], st[8], st[9]
    ab_te = ab_ts + jnp.where(ab_ok, ab_len, 0)
    return _pack_family(ab_ok, ab_ts, ab_te, ab_ts, ab_ts) \
        + _pack_family(*xab) + _pack_family(*abx) + _pack_family(*xabx)



@functools.partial(aot.jit, static_argnames=("mrs", "msym"))
def _contig_batch(refstr, refsa, rlp, lr_tar, sa_pos, lm, offs, mrs, msym):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    cs = refsa[sa_pos]
    f = functools.partial(_extract_contig_item, refstr, rlp, lr_tar, mrs, msym)
    return jax.vmap(f)(cs, lm)


@functools.partial(aot.jit, static_argnames=("mrs", "msym"))
def _contig_batch_pos(refstr, rlp, lr_tar, cs, lm, offs, mrs, msym):
    """Position-based variant for the sharded-index layout (occurrence
    positions already resolved from the rank-sharded SA)."""
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_extract_contig_item, refstr, rlp, lr_tar, mrs, msym)
    return jax.vmap(f)(cs, lm)


def extract_contiguous_tpu(index, blocks: Blocks, cfg: ExtractorConfig,
                           engine=None, defer=False):
    """Host orchestration for extractConsistentPairs_Gappy: sampled occurrence
    list -> device batch -> canonical compaction + stable id sort.
    ``defer=True`` returns a finisher callable after dispatching (lets the
    pipeline overlap the three extraction kernels' round-trips)."""
    if engine is None:
        from cgx_tpu.engine import ReplicatedEngine
        engine = ReplicatedEngine(index, None, cfg)
    G = len(blocks.start)
    lo = np.where(blocks.matchlen >= 1, blocks.start, 0)
    hi = np.where(blocks.matchlen >= 1, blocks.end, -1)
    bnums, tx = occurrence_lists(lo, hi, cfg.sampler, cfg.is_sample)
    sa_pos = blocks.start.astype(np.int64)[bnums] + tx
    lms = blocks.matchlen.astype(np.int64)[bnums]
    if len(bnums) == 0:
        empty = GapRules(*(np.empty(0, np.int32) for _ in range(7)))
        res0 = (ContigRules(*(np.empty(0, np.int32) for _ in range(3))),
                empty, empty)
        return (lambda: res0) if defer else res0
    pend = engine.contig(sa_pos, lms, fetch=False)

    def finish():
        out = pend.get()
        return _finish_contig(out, bnums, G)
    return finish if defer else finish()


def _finish_contig(out, bnums, G):
    (ab_tsp, ab_pk, x_tsp, x_pk, a_tsp, a_pk, t_tsp, t_pk) = out
    ab_v, ab_ts, ab_te, _, _ = unpack_family(ab_tsp, ab_pk)
    x_v, x_ts, x_te, x_g1s, x_g1e = unpack_family(x_tsp, x_pk)
    a_v, a_ts, a_te, a_g1s, a_g1e = unpack_family(a_tsp, a_pk)
    t_v, t_ts, t_te, t_g1s, t_g1e, t_g2s, t_g2e = unpack_family(
        t_tsp, t_pk, two_gaps=True)

    m = ab_v
    contig = ContigRules(tar_start=ab_ts[m].astype(np.int32),
                         tar_end=(ab_te - ab_ts)[m].astype(np.int32),
                         blocknumber=bnums[m].astype(np.int32))

    def gaprules(parts):
        rows = []
        for v, ts, te, g1s, g1e, g2s, g2e, gid in parts:
            if not v.any():
                continue
            rows.append(np.stack([
                ts[v], (te - ts)[v], (g1s - ts)[v], (g1e - ts)[v],
                (g2s - ts)[v], (g2e - ts)[v], gid[v]], axis=1).astype(np.int64))
        if not rows:
            return GapRules(*(np.empty(0, np.int32) for _ in range(7)))
        a = np.concatenate(rows, axis=0)
        a = a[np.argsort(a[:, 6], kind="stable")]
        return GapRules(ref_str_start=a[:, 0].astype(np.int32),
                        end=a[:, 1].astype(np.int32),
                        gap1=a[:, 2].astype(np.int32),
                        gap1_1=a[:, 3].astype(np.int32),
                        gap2=a[:, 4].astype(np.int32),
                        gap2_1=a[:, 5].astype(np.int32),
                        gappy_index=a[:, 6].astype(np.int32))

    # one-gap rules carry no second gap: store 0 offsets like the oracle
    rules1 = gaprules([
        (x_v, x_ts, x_te, x_g1s, x_g1e, x_ts, x_ts, bnums),            # Xab
        (a_v, a_ts, a_te, a_g1s, a_g1e, a_ts, a_ts, G + bnums),        # abX
    ])
    rules2 = gaprules([
        (t_v, t_ts, t_te, t_g1s, t_g1e, t_g2s, t_g2e, bnums),          # XabX
    ])
    return contig, rules1, rules2


# ---------------------------------------------------------------------------
# extractConsistentPairs_OneGap (ExtractPair.cu:351-889)
# ---------------------------------------------------------------------------

def _check_boundary_dev(refstr, rlp, lr_tar, start, ender, mrs):
    """checkBoundary (ExtractPair.cu:252-342) for spans <= CWID:
    returns (code, ts, te) with codes 0/1/2/3/4."""
    ks = start + jnp.arange(CWID, dtype=jnp.int32)
    mask = ks <= ender
    L, R, al = _rlp_LR(rlp, ks)
    span = ender - start
    end_off = jnp.clip(span, 0, CWID - 1)
    first_un = ~al[0]
    last_un = ~jnp.take(al, end_off)
    single = span == 0
    code_fw = jnp.where(
        single & first_un, 4,
        jnp.where(first_un & last_un, 4,
                  jnp.where(first_un, 2, jnp.where(last_un, 3, 0))))
    min_L = jnp.min(jnp.where(mask & al, L, 256))
    max_R = jnp.max(jnp.where(mask & al, R, -1))
    sentstart, stb = _sent_anchor(rlp, start)
    ts = min_L + stb
    te = max_R + stb
    ok_span = (min_L <= max_R) & (max_R - min_L < mrs)
    cons = _consistent_dev(lr_tar, ts, te, start, ender, sentstart)
    code = jnp.where(code_fw != 0, code_fw,
                     jnp.where(ok_span & cons, 1, 0))
    return code, ts, te, sentstart, stb


def _extract_onegap_item(refstr, rlp, lr_tar, mrs, msym, cs, first_end,
                         sl, el):
    """One sampled aXb occurrence: aXb + XaXb + aXbX slots."""
    ender = cs + first_end
    # first gap span anchor (checkBoundaryFast on [cs+sl, ender-el])
    gstart = cs + sl
    sentstart, stb = _sent_anchor(rlp, gstart)
    gks = gstart + jnp.arange(CWID, dtype=jnp.int32)
    gmask = gks <= ender - el
    gL, gR, gal = _rlp_LR(rlp, gks)
    gmin = jnp.min(jnp.where(gmask & gal, gL, 256))
    gmax = jnp.max(jnp.where(gmask & gal, gR, -1))
    gap1s = gmin + stb
    gap1e = gmax + stb

    code, ts, te, _, _ = _check_boundary_dev(refstr, rlp, lr_tar, cs,
                                             ender, mrs)
    min_L = ts - stb
    max_R = te - stb
    axb_v = code == 1
    # code 2 (front unaligned) kills aXbX (right); code 3 (end unaligned) kills
    # XaXb (left); code 4 kills both (ExtractPair.cu:574-588)
    left = (code != 3) & (code != 4)
    right = (code != 2) & (code != 4)

    grow = sl + el + 2 <= msym
    left &= grow
    right &= grow

    H = mrs - 1
    anchor = stb + jnp.minimum(min_L, 255)
    base_pref = _tar_window_prefixes(lr_tar, anchor, H)
    ltok, lal, lmin, lmax, lgap = _grow_side_arrays(
        refstr, rlp, lr_tar, cs, -1, sentstart, stb,
        lambda i: cs - i, lambda i: cs - 1, H)
    rtok, ral, rmin, rmax, rgap = _grow_side_arrays(
        refstr, rlp, lr_tar, ender, 1, sentstart, stb,
        lambda i: ender + 1, lambda i: ender + i, H)

    ir = jnp.arange(IMAX, dtype=jnp.int32)
    fwdL, bwdL, fwdR, bwdR = base_pref
    loL = jnp.clip(min_L - lmin, 0, H)
    hiL = jnp.clip(jnp.maximum(lmax, max_R) - min_L, 0, H)
    loR = jnp.clip(min_L - rmin, 0, H)
    hiR = jnp.clip(jnp.maximum(rmax, max_R) - min_L, 0, H)
    wl_ts = stb + jnp.minimum(lmin, min_L)
    wl_te = stb + jnp.maximum(lmax, max_R)
    wl_ok = (sentstart + jnp.minimum(bwdL[loL], fwdL[hiL]) == cs - (ir + 1)) \
        & (sentstart + jnp.maximum(bwdR[loL], fwdR[hiL]) == ender)
    wr_ts = stb + jnp.minimum(rmin, min_L)
    wr_te = stb + jnp.maximum(rmax, max_R)
    wr_ok = (sentstart + jnp.minimum(bwdL[loR], fwdL[hiR]) == cs) \
        & (sentstart + jnp.maximum(bwdR[loR], fwdR[hiR]) == ender + (ir + 1))

    def outer_body(i, st):
        left, right, xaxb, axbx = st
        i0 = i - 1
        F = jnp.bool_(False)
        active = (first_end + 1 + i <= mrs) & (left | right)
        # XaXb (prepend X), ExtractPair.cu:639-760
        l_has = (cs - i >= 0) & (ltok[i0] >= 2)
        l_proc = active & left & l_has
        left = jnp.where(active & left & ~l_has, F, left)
        nxt = l_proc & lal[i0]
        left = jnp.where(l_proc & ~lal[i0] & (i == 1), F, left)
        spank = lmax[i0] - lmin[i0] >= mrs
        left = jnp.where(l_proc & spank, F, left)
        nxt &= ~spank
        nxt &= lgap[i0]
        wkill = nxt & (wl_te[i0] - wl_ts[i0] >= mrs)
        left = jnp.where(wkill, F, left)
        emit = nxt & ~wkill & wl_ok[i0]
        xaxb = (xaxb[0] | emit,
                jnp.where(emit, wl_ts[i0], xaxb[1]),
                jnp.where(emit, wl_te[i0], xaxb[2]),
                jnp.where(emit, stb + lmin[i0], xaxb[3]),
                jnp.where(emit, stb + lmax[i0], xaxb[4]))
        left = jnp.where(emit, F, left)
        # aXbX (append X), ExtractPair.cu:763-880
        r_has = rtok[i0] >= 2
        r_proc = active & right & r_has
        right = jnp.where(active & right & ~r_has, F, right)
        nxt = r_proc & ral[i0]
        right = jnp.where(r_proc & ~ral[i0] & (i == 1), F, right)
        spank = rmax[i0] - rmin[i0] >= mrs
        right = jnp.where(r_proc & spank, F, right)
        nxt &= ~spank
        nxt &= rgap[i0]
        wkill = nxt & (wr_te[i0] - wr_ts[i0] >= mrs)
        right = jnp.where(wkill, F, right)
        emit = nxt & ~wkill & wr_ok[i0]
        axbx = (axbx[0] | emit,
                jnp.where(emit, wr_ts[i0], axbx[1]),
                jnp.where(emit, wr_te[i0], axbx[2]),
                jnp.where(emit, stb + rmin[i0], axbx[3]),
                jnp.where(emit, stb + rmax[i0], axbx[4]))
        right = jnp.where(emit, F, right)
        return (left, right, xaxb, axbx)

    F0 = jnp.bool_(False)
    z = jnp.int32(0)
    rule5 = (F0, z, z, z, z)
    _, _, xaxb, axbx = jax.lax.fori_loop(1, IMAX + 1, outer_body,
                                         (left, right, rule5, rule5))

    return _pack_family(axb_v, ts, te, gap1s, gap1e) \
        + _pack_family(xaxb[0], xaxb[1], xaxb[2], xaxb[3], xaxb[4],
                       jnp.where(xaxb[0], gap1s, xaxb[1]),
                       jnp.where(xaxb[0], gap1e, xaxb[1])) \
        + _pack_family(axbx[0], axbx[1], axbx[2],
                       jnp.where(axbx[0], gap1s, axbx[1]),
                       jnp.where(axbx[0], gap1e, axbx[1]),
                       axbx[3], axbx[4])
@functools.partial(aot.jit, static_argnames=("mrs", "msym"))
def _onegap_batch(refstr, rlp, lr_tar, cs, first_end, sl, el, offs, mrs, msym):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_extract_onegap_item, refstr, rlp, lr_tar,
                          mrs, msym)
    return jax.vmap(f)(cs, first_end, sl, el)


def _onegap_occurrences(search1, onegap_sa, pc, sampler, is_sample):
    """Per-pattern occurrence expansion with precomp-cell redirection."""
    lo0 = search1.start_on_salist.astype(np.int64)
    hi0 = search1.end_on_salist.astype(np.int64)
    has = lo0 >= 0
    loc = np.clip(lo0, 0, max(len(onegap_sa.length) - 1, 0))
    if len(onegap_sa.length):
        pcmode = has & (hi0 == lo0) & (onegap_sa.length[loc] == 0)
        pci = onegap_sa.str_position[loc].astype(np.int64)
    else:
        pcmode = np.zeros_like(has)
        pci = np.zeros_like(lo0)
    pcic = np.clip(pci, 0, len(pc.index_start) - 1)
    lo = np.where(pcmode, pc.index_start[pcic], lo0)
    hi = np.where(pcmode, pc.index_end[pcic], hi0)
    lo = np.where(has, lo, -1)
    hi = np.where(has, hi, -2)
    ids, tx = occurrence_lists(lo, hi, sampler, is_sample)
    row = lo[ids] + tx
    pcm = pcmode[ids]
    row_sa = np.clip(row, 0, max(len(onegap_sa.length) - 1, 0))
    row_pc = np.clip(row, 0, max(len(pc.onegap_start) - 1, 0))
    if len(onegap_sa.length):
        css = np.where(pcm, pc.onegap_start[row_pc] if len(pc.onegap_start)
                       else 0, onegap_sa.str_position[row_sa])
        fes = np.where(pcm, pc.onegap_length[row_pc] if len(pc.onegap_length)
                       else 0, onegap_sa.length[row_sa])
    else:
        css = pc.onegap_start[row_pc]
        fes = pc.onegap_length[row_pc]
    return ids, css.astype(np.int64), fes.astype(np.int64)


def extract_onegap_tpu(index, search1: OneGapSearch, onegap_sa: GapOnSA,
                       pc: Precomp, cfg: ExtractorConfig, engine=None,
                       defer=False):
    if engine is None:
        from cgx_tpu.engine import ReplicatedEngine
        engine = ReplicatedEngine(index, None, cfg)
    D1 = len(search1.qrystart)
    ids, css, fes = _onegap_occurrences(search1, onegap_sa, pc,
                                        cfg.sampler_onegap, cfg.is_sample)
    sls = search1.qrystart_len.astype(np.int64)[ids]
    els = search1.qryend_len.astype(np.int64)[ids]
    if len(ids) == 0:
        empty = GapRules(*(np.empty(0, np.int32) for _ in range(7)))
        res0 = (empty, empty)
        return (lambda: res0) if defer else res0
    ids = np.asarray(ids, dtype=np.int64)
    pend = engine.onegap(css, fes, sls, els, fetch=False)

    def finish():
        return _finish_onegap(pend.get(), ids, D1)
    return finish if defer else finish()


def _finish_onegap(out, ids, D1):
    (b_tsp, b_pk, l_tsp, l_pk, r_tsp, r_pk) = out
    b_v, b_ts, b_te, b_g1s, b_g1e = unpack_family(b_tsp, b_pk)
    l_v, l_ts, l_te, l_g1s, l_g1e, l_og1s, l_og1e = unpack_family(
        l_tsp, l_pk, two_gaps=True)
    r_v, r_ts, r_te, r_og1s, r_og1e, r_g2s, r_g2e = unpack_family(
        r_tsp, r_pk, two_gaps=True)

    def mk(parts):
        rows = []
        for v, ts, te, g1s, g1e, g2s, g2e, gid in parts:
            if not v.any():
                continue
            rows.append(np.stack([
                ts[v], (te - ts)[v], (g1s - ts)[v], (g1e - ts)[v],
                (g2s - ts)[v], (g2e - ts)[v], gid[v]], axis=1).astype(np.int64))
        if not rows:
            return GapRules(*(np.empty(0, np.int32) for _ in range(7)))
        a = np.concatenate(rows, axis=0)
        a = a[np.argsort(a[:, 6], kind="stable")]
        return GapRules(ref_str_start=a[:, 0].astype(np.int32),
                        end=a[:, 1].astype(np.int32),
                        gap1=a[:, 2].astype(np.int32),
                        gap1_1=a[:, 3].astype(np.int32),
                        gap2=a[:, 4].astype(np.int32),
                        gap2_1=a[:, 5].astype(np.int32),
                        gappy_index=a[:, 6].astype(np.int32))

    rules1 = mk([(b_v, b_ts, b_te, b_g1s, b_g1e, b_ts, b_ts, ids)])   # aXb
    # XaXb: gap1 = new left X, gap2 = original aXb gap; aXbX: gap1 = original,
    # gap2 = new right X (ExtractPair.cu:745-757, 866-877); the original-gap
    # offsets ride in each family's packed word
    rules2 = mk([
        (l_v, l_ts, l_te, l_g1s, l_g1e, l_og1s, l_og1e, ids),
        (r_v, r_ts, r_te, r_og1s, r_og1e, r_g2s, r_g2e,
         D1 + ids),
    ])
    return rules1, rules2


# ---------------------------------------------------------------------------
# extractConsistentPairs_TwoGap (ExtractPair.cu:891-1053)
# ---------------------------------------------------------------------------

def _extract_twogap_item(refstr, rlp, lr_tar, mrs, cs, first_end,
                         second_end, sl, el, cl):
    gs1, stb1 = _sent_anchor(rlp, cs + sl)

    def gapspan(start, ender):
        ks = start + jnp.arange(CWID, dtype=jnp.int32)
        mask = ks <= ender
        L, R, al = _rlp_LR(rlp, ks)
        mn = jnp.min(jnp.where(mask & al, L, 256))
        mx = jnp.max(jnp.where(mask & al, R, -1))
        sstart, sb = _sent_anchor(rlp, start)
        return mn + sb, mx + sb

    g1s, g1e = gapspan(cs + sl, cs + first_end - el)
    g2s, g2e = gapspan(cs + first_end + 1, cs + second_end - cl)
    code, ts, te, _, _ = _check_boundary_dev(refstr, rlp, lr_tar, cs,
                                             cs + second_end, mrs)
    return _pack_family(code == 1, ts, te, g1s, g1e, g2s, g2e)


@functools.partial(aot.jit, static_argnames=("mrs",))
def _twogap_batch(refstr, rlp, lr_tar, cs, fe, se, sl, el, cl, offs, mrs):
    refstr, rlp, lr_tar = make_views(refstr, rlp, lr_tar, offs)
    f = functools.partial(_extract_twogap_item, refstr, rlp, lr_tar, mrs)
    return jax.vmap(f)(cs, fe, se, sl, el, cl)


def extract_twogap_tpu(index, search1: OneGapSearch, search2: TwoGapSearch,
                       twogap_sa: GapOnSA, cfg: ExtractorConfig,
                       engine=None, defer=False):
    if engine is None:
        from cgx_tpu.engine import ReplicatedEngine
        engine = ReplicatedEngine(index, None, cfg)
    D2 = len(search2.blockid)
    ids, tx = occurrence_lists(search2.start_on_salist, search2.end_on_salist,
                               cfg.sampler_twogap, cfg.is_sample)
    row = search2.start_on_salist.astype(np.int64)[ids] + tx
    css = twogap_sa.str_position.astype(np.int64)[row] if len(row) else row
    fes = twogap_sa.length.astype(np.int64)[row] if len(row) else row
    ses = twogap_sa.length2.astype(np.int64)[row] if len(row) else row
    one_ids = search2.blockid.astype(np.int64)[ids] if len(ids) else ids
    sls = search1.qrystart_len.astype(np.int64)[one_ids] if len(ids) else ids
    els = search1.qryend_len.astype(np.int64)[one_ids] if len(ids) else ids
    cls = search2.qryend_len.astype(np.int64)[ids] if len(ids) else ids
    if len(ids) == 0:
        res0 = GapRules(*(np.empty(0, np.int32) for _ in range(7)))
        return (lambda: res0) if defer else res0
    pend = engine.twogap(css, fes, ses, sls, els, cls, fetch=False)

    def finish():
        return _finish_twogap(pend.get(), ids)
    return finish if defer else finish()


def _finish_twogap(out, ids):
    v, ts, te, g1s, g1e, g2s, g2e = unpack_family(out[0], out[1],
                                                  two_gaps=True)
    m = v
    a = np.stack([ts[m], (te - ts)[m], (g1s - ts)[m], (g1e - ts)[m],
                  (g2s - ts)[m], (g2e - ts)[m], ids[m]], axis=1).astype(np.int64)
    a = a[np.argsort(a[:, 6], kind="stable")]
    return GapRules(ref_str_start=a[:, 0].astype(np.int32),
                    end=a[:, 1].astype(np.int32),
                    gap1=a[:, 2].astype(np.int32),
                    gap1_1=a[:, 3].astype(np.int32),
                    gap2=a[:, 4].astype(np.int32),
                    gap2_1=a[:, 5].astype(np.int32),
                    gappy_index=a[:, 6].astype(np.int32))
