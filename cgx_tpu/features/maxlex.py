"""MaxLex feature scoring.

Transcription of lexicalTaskMaxEF (ExtractPair.cu:2144-2432): per distinct rule,
the max lexical probability per source word over the rule's (non-gap) target words
plus NULL, and vice versa, via binary search of the sorted lexical table
(searchLexFile, ExtractPair.cu:2108-2142); the ``-log10`` accumulation keeps the
reference's exact sequential float32 rounding order, so features are bit-identical
to the oracle.

Two backends produce bit-identical float32 features:

* **device** (default when the index is device-resident and the batch is large):
  the probe set — T rules x 5 source words x 16 target positions — runs on the
  device against device-resident NEG-LOG tables (``-log10`` precomputed on the
  host with numpy bits; +inf for missing entries), so ``max(prob)`` becomes
  ``min(neglog)`` — bit-identical because -log10 is monotone decreasing — and
  the reference's sequential f32 accumulation unrolls on device (pure f32
  adds in host order; XLA does not reassociate).  Only the final [T]+[T]
  float32 feature columns come back: 8 B/rule D2H instead of the 84 B/rule
  best tables.
* **host** (CPU fallback / sharded-index mode / small batches): dense
  per-direction probability matrices indexed directly when the (src, tgt) id
  space is small, batched ``np.searchsorted`` over packed int64 keys
  otherwise; ``-log10`` accumulation in the reference's sequential order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cgx_tpu.utils import aot
import numpy as np

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.index.container import pack_lex_key

TPOSW = 16   # target span width (end offset < max_rule_span)
SRCW = 5     # max source words (MAX_rule_symbols)

# below this many rules the host numpy pass is used: the device path's
# dispatch, upload and fetch are a fixed cost that a small batch cannot repay
DEVICE_MIN_T = 4096


def _lookup(lex_key, lex_val, keys):
    """Batched searchLexFile: value at key or 0.0 (ExtractPair.cu:2108-2142)."""
    i = np.searchsorted(lex_key, keys)
    ic = np.minimum(i, len(lex_key) - 1)
    found = (i < len(lex_key)) & (lex_key[ic] == keys)
    return np.where(found, lex_val[ic], np.float32(0)).astype(np.float32)


DENSE_LIMIT = 1 << 26  # max dense-matrix entries (256 MB of float32)


def _probe_bests_host(lex_key, lex_val1, lex_val2, src_pat, ttok, tmask,
                      any_t):
    """(fge_best [T,SRCW], egf_best [T,TPOSW]) on the host.

    Dense path: direct int32 row/column indexing into per-direction probability
    matrices — no packed int64 key temporaries (at T~10^5 the key pack plus its
    unpacks cost ~3x the gather itself on a memory-bound host).  Identical
    values: first table row wins on duplicate pairs, like searchsorted."""
    n = len(lex_key)
    dense = False
    if n:
        src = (lex_key >> 32).astype(np.int64)
        tgt = (lex_key & 0xFFFFFFFF).astype(np.int64) - 2**31
        si_t = src + 1
        ti_t = tgt + 1
        ns = int(si_t.max()) + 1
        nt = int(ti_t.max()) + 1
        dense = ns * nt <= DENSE_LIMIT
    if dense:
        M1 = np.zeros((ns, nt), dtype=np.float32)
        M2 = np.zeros((ns, nt), dtype=np.float32)
        M1[si_t[::-1], ti_t[::-1]] = np.asarray(lex_val1, np.float32)[::-1]
        M2[si_t[::-1], ti_t[::-1]] = np.asarray(lex_val2, np.float32)[::-1]
        si = src_pat.astype(np.int32) + 1                       # [T, 5]
        ti = ttok.astype(np.int32) + 1                          # [T, 16]
        oks = (si >= 0) & (si < ns)                             # src id known
        okt = (ti >= 0) & (ti < nt)
        sic = np.where(oks, si, 0)
        tic = np.where(okt, ti, 0)
        okb = oks[:, :, None] & okt[:, None, :]
        z = np.float32(0)
        v2 = np.where(okb, M2[sic[:, :, None], tic[:, None, :]], z)
        fge_best = np.max(np.where(tmask[:, None, :], v2, z), axis=2)
        v2null = np.where(oks, M2[sic, 0], z)                   # tgt NULL = col 0
        fge_best = np.where(any_t[:, None], np.maximum(fge_best, v2null),
                            fge_best)
        v1 = np.where(okb, M1[sic[:, :, None], tic[:, None, :]], z)
        egf_best = np.max(np.where(oks[:, :, None], v1, z), axis=1)
        v1null = np.where(okt, M1[0, tic], z)                   # src NULL = row 0
        egf_best = np.maximum(egf_best, v1null)
        return fge_best, egf_best

    sp = src_pat.astype(np.int64)
    tt = ttok.astype(np.int64)
    keys = pack_lex_key(sp[:, :, None], tt[:, None, :])         # [T, 5, 16]
    v2 = _lookup(lex_key, lex_val2, keys)                       # P(t|s) side
    v1 = _lookup(lex_key, lex_val1, keys)                       # P(s|t) side
    v2null = _lookup(lex_key, lex_val2, pack_lex_key(sp, np.full_like(sp, -1)))
    v1null = _lookup(lex_key, lex_val1, pack_lex_key(np.full_like(tt, -1), tt))
    fge_best = np.max(np.where(tmask[:, None, :], v2, np.float32(0)), axis=2)
    fge_best = np.where(any_t[:, None], np.maximum(fge_best, v2null), fge_best)
    src_valid = src_pat >= -1  # padded entries are -99
    egf_best = np.max(np.where(src_valid[:, :, None], v1, np.float32(0)),
                      axis=1)
    egf_best = np.maximum(egf_best, v1null)
    return fge_best, egf_best


# ---------------------------------------------------------------------------
# Device probe.  The probes are random gathers, so the design goal is the
# fewest gathered words per probe:
#   dense mode  — per-direction [ns, nt] probability matrices resident in
#                 device memory, one 2D gather per probe (2 words over both
#                 directions);
#   range mode  — a dense per-src row-range table plus a binary search over the
#                 tgt column only (2 + ~log2(max rows per src) words) when the
#                 id-space square exceeds DEV_DENSE_LIMIT.
# Gathers and maxes are exact, so the float32 bests are bit-equal to the host
# backends (first table row wins on duplicate pairs in both modes).
# ---------------------------------------------------------------------------

# max dense-matrix entries per direction on device (2 x 512 MB)
DEV_DENSE_LIMIT = 1 << 27


def _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21):
    pos = t0[:, None] + jnp.arange(TPOSW, dtype=jnp.int32)[None, :]
    ttok = tgt_str[jnp.clip(pos, 0, tgt_str.shape[0] - 1)]
    inside = pos <= (t0 + tend)[:, None]
    out1 = (g1 < 0)[:, None] | (pos < (t0 + g1)[:, None]) | \
        (pos > (t0 + g11)[:, None])
    out2 = (g2 < 0)[:, None] | (pos < (t0 + g2)[:, None]) | \
        (pos > (t0 + g21)[:, None])
    tmask = inside & out1 & out2
    return ttok, tmask, tmask.any(axis=1)


def _accum_sequential(term_fge, nsrc, term_egf, tmask):
    """The reference's sequential float32 accumulation (ExtractPair.cu's
    per-word loop), unrolled on device: pure f32 adds in the exact host
    order (XLA does not reassociate float adds), so the results are
    bit-identical to the host loop in compute_maxlex_tpu."""
    T = term_fge.shape[0]
    fge = jnp.zeros(T, jnp.float32)
    for j in range(SRCW):
        fge = jnp.where(j < nsrc, fge + term_fge[:, j], fge)
    egf = jnp.zeros(T, jnp.float32)
    for p in range(TPOSW):
        egf = jnp.where(tmask[:, p], egf + term_egf[:, p], egf)
    return fge, egf


@aot.jit
def _accum_batch_dense(L1, L2, tgt_str, maxscore, sp, t0, tend, g1, g11,
                       g2, g21):
    """Dense-matrix probe + on-device accumulation over NEG-LOG tables:
    ``L* = -log10(prob)`` (host-precomputed numpy bits; +inf for missing or
    non-positive entries), so ``max(prob)`` becomes ``min(neglog)`` —
    bit-identical because -log10 is monotone decreasing and np.log10 is
    monotone.  Returns the final [T] f32 feature columns: D2H shrinks from
    (SRCW + TPOSW) x 4 = 84 B/rule (the best tables) to 8 B/rule."""
    ttok, tmask, any_t = _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    ns, nt = L1.shape
    si = sp + 1                                      # [T, 5]; NULL src -> row 0
    ti = ttok + 1                                    # [T, 16]; NULL tgt -> col 0
    oks = (si >= 0) & (si < ns)
    okt = (ti >= 0) & (ti < nt)
    sic = jnp.where(oks, si, 0)
    tic = jnp.where(okt, ti, 0)
    okb = oks[:, :, None] & okt[:, None, :]
    INF = jnp.float32(jnp.inf)
    l2 = jnp.where(okb, L2[sic[:, :, None], tic[:, None, :]], INF)
    best2 = jnp.min(jnp.where(tmask[:, None, :], l2, INF), axis=2)
    l2null = jnp.where(oks, L2[sic, 0], INF)
    best2 = jnp.where(any_t[:, None], jnp.minimum(best2, l2null), best2)
    term_fge = jnp.where(jnp.isfinite(best2), best2, maxscore)
    l1 = jnp.where(okb, L1[sic[:, :, None], tic[:, None, :]], INF)
    best1 = jnp.min(jnp.where((sp >= -1)[:, :, None], l1, INF), axis=1)
    l1null = jnp.where(okt, L1[0, tic], INF)
    best1 = jnp.minimum(best1, l1null)
    term_egf = jnp.where(jnp.isfinite(best1), best1, maxscore)
    nsrc = jnp.sum(sp != -99, axis=1)
    return _accum_sequential(term_fge, nsrc, term_egf, tmask)


def _tgt_range_lookup_neglog(lt, lv, lo0, hi0, t, steps: int):
    """neg-log value at tgt ``t`` within the sorted row range [lo0, hi0),
    +inf when absent (lv holds the precomputed neg-log column)."""
    shp = jnp.broadcast_shapes(jnp.shape(lo0), jnp.shape(hi0), jnp.shape(t))
    lo = jnp.broadcast_to(lo0, shp).astype(jnp.int32)
    hi = jnp.broadcast_to(hi0, shp).astype(jnp.int32)
    t = jnp.broadcast_to(t, shp)
    hi_init = hi
    n = lt.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        ms = lt[jnp.clip(mid, 0, n - 1)]
        less = ms < t
        sel = lo < hi
        lo = jnp.where(sel & less, mid + 1, lo)
        hi = jnp.where(sel & ~less, mid, hi)
    loc = jnp.clip(lo, 0, n - 1)
    found = (lo < hi_init) & (lt[loc] == t)
    return jnp.where(found, lv[loc], jnp.float32(jnp.inf))


@functools.partial(aot.jit, static_argnames=("steps",))
def _accum_batch_range(rs, re, lt, lnv1, lnv2, tgt_str, maxscore, sp, t0,
                       tend, g1, g11, g2, g21, steps):
    """Row-range probe over NEG-LOG value columns + on-device accumulation
    (see _accum_batch_dense for the monotonicity/bit-identity argument)."""
    ttok, tmask, any_t = _probe_masks(tgt_str, t0, tend, g1, g11, g2, g21)
    ns = rs.shape[0]
    si = sp + 1                                      # [T, 5]
    oks = (si >= 0) & (si < ns)
    sic = jnp.where(oks, si, 0)
    lo = jnp.where(oks, rs[sic], 0)                  # empty range when invalid
    hi = jnp.where(oks, re[sic], 0)
    t3 = ttok[:, None, :]
    l2 = _tgt_range_lookup_neglog(lt, lnv2, lo[:, :, None], hi[:, :, None],
                                  t3, steps)
    l1 = _tgt_range_lookup_neglog(lt, lnv1, lo[:, :, None], hi[:, :, None],
                                  t3, steps)
    nullt = jnp.full_like(sp, -1)
    l2null = _tgt_range_lookup_neglog(lt, lnv2, lo, hi, nullt, steps)
    # src NULL = id -1 = row-range 0
    lo0 = jnp.broadcast_to(rs[0], ttok.shape)
    hi0 = jnp.broadcast_to(re[0], ttok.shape)
    l1null = _tgt_range_lookup_neglog(lt, lnv1, lo0, hi0, ttok, steps)
    INF = jnp.float32(jnp.inf)
    best2 = jnp.min(jnp.where(tmask[:, None, :], l2, INF), axis=2)
    best2 = jnp.where(any_t[:, None], jnp.minimum(best2, l2null), best2)
    term_fge = jnp.where(jnp.isfinite(best2), best2, maxscore)
    best1 = jnp.min(jnp.where((sp >= -1)[:, :, None], l1, INF), axis=1)
    best1 = jnp.minimum(best1, l1null)
    term_egf = jnp.where(jnp.isfinite(best1), best1, maxscore)
    nsrc = jnp.sum(sp != -99, axis=1)
    return _accum_sequential(term_fge, nsrc, term_egf, tmask)


def _neglog(v: np.ndarray) -> np.ndarray:
    """Host-precomputed ``-log10`` (numpy bits, f32): +inf for non-positive
    entries, so a zero/absent probability can never win a device min.

    ``-log10(1.0) = -0.0``: the host accumulator's ``0.0 + (-0.0)`` yields
    ``+0.0``, but XLA may fold the device accumulator's ``zeros + term`` to
    ``term``, which would leak ``-0.0`` into the printed feature.
    Canonicalizing ``±0 -> +0`` here makes
    every device add bit-equal to the host's regardless of that fold
    (x + 0.0 == x + (-0.0) for every x the accumulator can hold)."""
    v = np.asarray(v, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(v > 0, (-np.log10(np.where(v > 0, v, 1.0)))
                       .astype(np.float32), np.float32(np.inf))
    return np.where(out == 0, np.float32(0.0), out)


def _device_lex_tables(index):
    """Cached device-resident NEG-LOG probe tables: dense [ns, nt] matrices
    when the id-space square fits DEV_DENSE_LIMIT, else a dense per-src
    row-range table over the sorted tgt/neg-log columns.  Missing entries
    hold +inf (see _accum_batch_dense)."""
    cached = getattr(index, "_maxlex_dev", None)
    if cached is not None:
        return cached
    lex_key = index.lex_key
    src = (lex_key >> 32).astype(np.int64)
    tgt = ((lex_key & 0xFFFFFFFF) - 2**31).astype(np.int64)
    n = len(src)
    ns = int(src.max()) + 2 if n else 1
    nt = int(tgt.max()) + 2 if n else 1
    l1 = _neglog(index.lex_val1_host)
    l2 = _neglog(index.lex_val2_host)
    if ns * nt <= DEV_DENSE_LIMIT:
        L1 = np.full((ns, nt), np.inf, dtype=np.float32)
        L2 = np.full((ns, nt), np.inf, dtype=np.float32)
        L1[src[::-1] + 1, tgt[::-1] + 1] = l1[::-1]  # first row wins
        L2[src[::-1] + 1, tgt[::-1] + 1] = l2[::-1]
        out = ("dense", (jnp.asarray(L1), jnp.asarray(L2)))
    else:
        # per-src row ranges over the (src, tgt)-sorted columns
        rs = np.searchsorted(src + 1, np.arange(ns)).astype(np.int32)
        re = np.searchsorted(src + 1, np.arange(ns) + 1).astype(np.int32)
        max_rows = int((re - rs).max()) if n else 1
        steps = max(int(max_rows).bit_length(), 1)
        out = ("range", (jnp.asarray(rs), jnp.asarray(re),
                         jnp.asarray(tgt.astype(np.int32)),
                         jnp.asarray(l1), jnp.asarray(l2), steps))
    try:
        index._maxlex_dev = out
    except Exception:   # frozen containers: rebuild per call (still cheap)
        pass
    return out


def _accum_device(index, cfg, src_pat, t0, tend, g1, g11, g2, g21):
    """Device probe + accumulation: uploads the [T]-column task arrays,
    returns the FINAL [T] f32 feature columns (8 B/rule D2H in place of the
    84 B/rule best tables).  The target string and neg-log lexical tables are
    device-resident."""
    from cgx_tpu.utils.batching import chunked_batch

    mode, tabs = _device_lex_tables(index)
    tgt_dev = index.tgt_str
    maxscore = jnp.float32(cfg.max_score)
    cols = [np.ascontiguousarray(src_pat, np.int32)] + [
        np.asarray(a, np.int32) for a in (t0, tend, g1, g11, g2, g21)]
    if mode == "dense":
        L1, L2 = tabs
        fn = lambda *a: _accum_batch_dense(L1, L2, tgt_dev, maxscore, *a)
    else:
        rs, re, lt, lnv1, lnv2, steps = tabs
        fn = lambda *a: _accum_batch_range(rs, re, lt, lnv1, lnv2, tgt_dev,
                                           maxscore, *a, steps=steps)
    # single-device probe programs (the sharded layout scores on the host
    # lex index, never here) — first-time compiles overlap on the pool
    out = chunked_batch(fn, cols, parallel_compile=True)
    return out[0], out[1]


def compute_maxlex_tpu(task_arrays: dict, index, rules_one, rules_two,
                       rules_contig, cfg: ExtractorConfig,
                       use_device: bool = None):
    """Scores the families' TaskArrays, accumulates in reference float32 order,
    scatters into the rules (row d of a family's TaskArrays is its distinct
    rule d).  ``use_device`` overrides the backend choice (None = device when
    the index is device-resident and the batch is large enough)."""
    by_kind = {"onegap": rules_one, "twogap": rules_two, "contig": rules_contig}
    kinds = [k for k in ("onegap", "twogap", "contig")
             if len(task_arrays[k].t0)]
    if not kinds:
        return
    src_pat = np.concatenate([task_arrays[k].src_pat for k in kinds])
    t0 = np.concatenate([task_arrays[k].t0 for k in kinds]).astype(np.int64)
    tend = np.concatenate([task_arrays[k].tend for k in kinds]).astype(np.int64)
    g1 = np.concatenate([task_arrays[k].g1 for k in kinds]).astype(np.int64)
    g11 = np.concatenate([task_arrays[k].g11 for k in kinds]).astype(np.int64)
    g2 = np.concatenate([task_arrays[k].g2 for k in kinds]).astype(np.int64)
    g21 = np.concatenate([task_arrays[k].g21 for k in kinds]).astype(np.int64)
    T = len(t0)

    from cgx_tpu.utils.timing import StageMarks
    mk = StageMarks("maxlex")
    mk.mark("prep")
    if use_device is None:
        use_device = (getattr(index, "tgt_str", None) is not None
                      and T >= DEVICE_MIN_T)
    if use_device:
        # device path: neg-log min probe + the same sequential f32
        # accumulation on device (bit-identical; see _accum_batch_dense)
        fge, egf = _accum_device(index, cfg, src_pat, t0, tend,
                                 g1, g11, g2, g21)
        fge = np.asarray(fge)
        egf = np.asarray(egf)
        mk.mark("probe_dev")
    else:
        nsrc = (src_pat != -99).sum(axis=1).astype(np.int64)
        pos = t0[:, None] + np.arange(TPOSW, dtype=np.int64)[None, :]
        inside = pos <= (t0 + tend)[:, None]
        out1 = (g1 < 0)[:, None] | (pos < (t0 + g1)[:, None]) | \
            (pos > (t0 + g11)[:, None])
        out2 = (g2 < 0)[:, None] | (pos < (t0 + g2)[:, None]) | \
            (pos > (t0 + g21)[:, None])
        tmask = inside & out1 & out2
        any_t = tmask.any(axis=1)
        tgt_str = index.tgt_str_host
        ttok = tgt_str[np.clip(pos, 0, len(tgt_str) - 1)].astype(np.int64)
        fge_best, egf_best = _probe_bests_host(
            index.lex_key, index.lex_val1_host, index.lex_val2_host, src_pat,
            ttok, tmask, any_t)
        mk.mark("probe")

        maxscore = np.float32(cfg.max_score)
        fge = np.zeros(T, dtype=np.float32)
        with np.errstate(divide="ignore"):
            for j in range(SRCW):
                m = j < nsrc
                best = fge_best[:, j]
                term = np.where(best > 0,
                                (-np.log10(np.where(best > 0, best, 1.0))
                                 ).astype(np.float32), maxscore)
                fge = np.where(m, (fge + term).astype(np.float32), fge)
            egf = np.zeros(T, dtype=np.float32)
            for p in range(TPOSW):
                m = tmask[:, p]
                best = egf_best[:, p]
                term = np.where(best > 0,
                                (-np.log10(np.where(best > 0, best, 1.0))
                                 ).astype(np.float32), maxscore)
                egf = np.where(m, (egf + term).astype(np.float32), egf)

    off = 0
    for k in kinds:
        rules = by_kind[k]  # RuleTable; row d of a family's tasks = rule d
        nk = len(rules)
        rules.max_lex_fge[:] = fge[off:off + nk]
        rules.max_lex_egf[:] = egf[off:off + nk]
        off += nk
    mk.mark("accum")
    mk.done()
