"""Dispatch engines for the device stages.

The lookup/extraction orchestrators express their device work against a small
engine protocol so the same host logic drives both index layouts:

* ``ReplicatedEngine`` — the whole index resident on one device
  (cgx_tpu.index.container.GrammarIndex), batch kernels dispatched directly;
* ``cgx_tpu.parallel.sharded.ShardedEngine`` — every O(corpus) array split
  across a mesh; work items partitioned to the shard owning the corpus
  position they read around, SA values fetched with distributed gathers.

Methods (all take/return host numpy; device placement is the engine's
business): ``sa_values``, ``fwd``, ``bwd``, ``pcs``, ``two``, ``contig``,
``onegap``, ``twogap``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cgx_tpu.utils.batching import Pending, chunked_batch

# dispatch chunk sizes for the expanded lookup kernels: their per-item device
# temps are tiny (scalars / one MMOV window), so they take much larger chunks
# than the default — fewer dispatches for the same device memory
PCS_CHUNK = 2_097_152
SCAN_CHUNK = 524_288


def _offsets(counts) -> np.ndarray:
    """Exclusive prefix [D+1] of per-pattern item counts."""
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def materialize_items(counts):
    """Flat work-item list from per-pattern counts: (item_pat, tx) where
    ``item_pat[i]`` is item i's pattern index and ``tx[i]`` its occurrence
    offset within that pattern.  Vectorized np.repeat/cumsum on the host, in
    place of a count-prefix binary search on device (~log2(D) gathered words
    per item)."""
    counts = np.asarray(counts, np.int64)
    item_pat = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    cum = np.cumsum(counts)
    tx = np.arange(len(item_pat), dtype=np.int64) \
        - np.repeat(cum - counts, counts)
    return item_pat, tx


def expand_hits(hit_idx, counts, ids=None):
    """Map flat item indices back to (pattern, tx) using the count prefix.
    ``ids`` optionally maps local pattern index -> caller pattern id."""
    cum = np.cumsum(counts)
    pi = np.searchsorted(cum, hit_idx, side="right")
    tx = hit_idx - (cum[pi] - counts[pi])
    pat = ids[pi] if ids is not None else pi
    return pat, tx, pi




def _expanded_dispatch(disp, N, offs, chunk, parallel=True):
    """pow2 chunk plan over an expanded item axis with concurrent
    first-per-size dispatch (the shared boilerplate of the *_expanded
    methods): ``disp(start, pat0, n_call)`` dispatches items
    [start, start+n_call); returns [(result, n_real)] in chunk order.
    ``parallel=False`` keeps every dispatch on the calling thread (used by
    per-device sub-engines whose callers already run on the pool)."""
    from cgx_tpu.utils.batching import (chunk_plan, bucket_size, MIN_BUCKET,
                                        compile_pool)
    plan = []
    s = 0
    for ni in chunk_plan(N, chunk, chunk // 8):
        n_call = ni if (ni & (ni - 1)) == 0 and ni >= MIN_BUCKET \
            else bucket_size(ni)
        pat0 = max(int(np.searchsorted(offs, s, side="right")) - 1, 0)
        plan.append((s, pat0, n_call, ni))
        s += ni
    results = [None] * len(plan)
    if parallel:
        first_of_size = {}
        for i, (_, _, n_call, _) in enumerate(plan):
            first_of_size.setdefault(n_call, i)
        if len(first_of_size) > 1:
            futs = [(i, compile_pool().submit(disp, *plan[i][:3]))
                    for i in first_of_size.values()]
            for i, f in futs:
                results[i] = f.result()
    for i, (s_, pat0_, n_call_, _) in enumerate(plan):
        if results[i] is None:
            results[i] = disp(s_, pat0_, n_call_)
    return [(results[i], plan[i][3]) for i in range(len(plan))]


class ReplicatedEngine:
    """Single-device dispatch against a fully-resident GrammarIndex.

    The lookup stages use the ``*_expanded`` entry points: per-pattern tables
    upload and the work items are derived on device from them (see
    search.lookup._cumsum_expand); only packed hit masks come back, so D2H
    stays O(items/8).  Extraction uploads per-item columns built on the host
    (ROADMAP S5 re-decides that format from a trace)."""

    # single-device programs: orchestrators may dispatch independent kernel
    # groups from threads (first-time compiles overlap); the sharded engine
    # keeps this False — its programs are collectives that every process must
    # dispatch in the same order
    parallel_dispatch_safe = True

    def __init__(self, index, sa_host: np.ndarray, cfg, device=None):
        self.index = index
        self.sa_host = sa_host
        self.cfg = cfg
        # ``device``: pin every upload/program to one local device (the
        # LocalDPEngine runs one sub-engine per device).  Sub-engines keep
        # their dispatches on the calling thread — their callers already fan
        # out, so nesting onto the shared compile pool could starve it.
        self.device = device
        self._parallel = device is None

    def _put(self, x):
        """Host->device upload committed to this engine's device."""
        if self.device is None:
            return jnp.asarray(x)
        import jax
        return jax.device_put(x, self.device)

    def sa_values(self, rows) -> np.ndarray:
        return self.sa_host[np.asarray(rows, np.int64)].astype(np.int32)

    @staticmethod
    def _qtok_host(queries) -> np.ndarray:
        """Padded host query tokens (safe for +2 lookahead indexing); cached
        on the QuerySet instance (lifetime-tied, no id() aliasing)."""
        return queries.padded_tokens()

    def _qtok_dev(self, queries):
        """Device query tokens committed to this engine's device (cached per
        placement on the QuerySet instance)."""
        return queries.device_tokens(self.device)

    def pass1_items(self, queries, toks, suffixlens, fetch=True):
        """Pass-1 LCP binary search over an explicit token-item slice
        (search.passes._pass1_batch); returns the 6 result columns."""
        from cgx_tpu.search.passes import _pass1_batch
        ix = self.index
        return chunked_batch(
            lambda a, b: _pass1_batch(
                ix.refstr_padded, ix.sa, ix.lcpleft, ix.lcpright,
                self._qtok_dev(queries), self._put(a), self._put(b),
                jnp.int32(ix.reflen)),
            [np.asarray(toks, np.int32), np.asarray(suffixlens, np.int32)],
            fetch=fetch, parallel_compile=self._parallel)

    def pass2_items(self, queries, toks, matches, LLs, MMs, RRs, fetch=True):
        """Pass-2 range search over an explicit work-item slice."""
        from cgx_tpu.search.passes import _pass2_batch
        ix = self.index
        return chunked_batch(
            lambda *a: _pass2_batch(
                ix.refstr_padded, ix.sa, ix.lcpleft, ix.lcpright,
                self._qtok_dev(queries), *(self._put(x) for x in a)),
            [np.asarray(toks, np.int32), np.asarray(matches, np.int32),
             np.asarray(LLs, np.int32), np.asarray(MMs, np.int32),
             np.asarray(RRs, np.int32)],
            fetch=fetch, parallel_compile=self._parallel)

    def _pc_rows_dev(self, pc):
        """Device-cached [n_pc, 2] (start, len) precomp occurrence rows,
        keyed per device (the LocalDPEngine holds one replica per device)."""
        cache = getattr(pc, "_dev_rows", None)
        if cache is None:
            cache = {}
            try:
                pc._dev_rows = cache
            except Exception:
                pass
        rows = cache.get(self.device)
        if rows is None:
            from cgx_tpu.utils.batching import bucket_size
            n = max(len(pc.onegap_start), 1)
            m = bucket_size(n)
            host = np.zeros((m, 2), np.int32)
            host[:len(pc.onegap_start), 0] = pc.onegap_start
            host[:len(pc.onegap_length), 1] = pc.onegap_length
            rows = cache[self.device] = self._put(host)
        return rows

    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok,
                     fetch=True):
        from cgx_tpu.search.lookup import _pcs_batch_exp
        from cgx_tpu.utils.batching import bucket_size
        ix, cfg = self.index, self.cfg
        counts = np.asarray(counts, np.int64)
        offs = _offsets(counts)
        N = int(offs[-1])
        D = len(counts)
        qtok = self._qtok_host(queries)
        sl64 = np.asarray(sl, np.int64)
        el64 = np.asarray(el, np.int64)
        tok64 = np.asarray(tok, np.int64)
        stok64 = np.asarray(stok, np.int64)
        # per-pattern field rows: pc-row base, sl, el, four resolved q tokens
        pattab = np.zeros((bucket_size(max(D, 1)), 8), np.int32)
        pattab[:D, 0] = np.asarray(base, np.int64)
        pattab[:D, 1] = sl64
        pattab[:D, 2] = el64
        pattab[:D, 3] = qtok[tok64 + np.maximum(sl64 - 2, 0)]
        pattab[:D, 4] = qtok[tok64 + np.maximum(sl64 - 3, 0)]
        pattab[:D, 5] = qtok[stok64 + 1]
        pattab[:D, 6] = qtok[stok64 + 2]
        offs_pad = np.full(len(pattab) + 1, offs[-1], np.int64)
        offs_pad[:D + 1] = offs
        pcrows = self._pc_rows_dev(pc)
        pattab_d = self._put(pattab)
        offs_d = self._put(offs_pad.astype(np.int32))
        def _disp(s_, pat0_, n_call_):
            return _pcs_batch_exp(
                ix.refstr_padded, pcrows, pattab_d, offs_d, jnp.int32(s_),
                jnp.int32(pat0_), jnp.int32(D), ix.offs0, cfg.max_rule_span,
                n_call_)

        pending = _expanded_dispatch(_disp, N, offs, PCS_CHUNK,
                                     parallel=self._parallel)

        def _post():
            import jax
            parts = [np.asarray(jax.device_get(res)[0])[: -(-ni // 32)]
                     for res, ni in pending]
            bits = np.ascontiguousarray(np.concatenate(parts)
                                        if parts else np.empty(0, np.uint32))
            ok = np.unpackbits(bits.view(np.uint8),
                               bitorder="little")[:N].astype(bool)
            return (ok,)
        return _post() if fetch else Pending(_post)

    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side,
                      fetch=True, do_gap=True):
        import os
        if os.environ.get("CGX_SCAN_COLS"):
            return self._scan_expanded_cols(queries, fwd, lo, counts, sl, el,
                                            side, fetch, do_gap)
        from cgx_tpu.search.lookup import _scan_batch_exp
        from cgx_tpu.utils.batching import bucket_size
        ix, cfg = self.index, self.cfg
        counts = np.asarray(counts, np.int64)
        offs = _offsets(counts)
        N = int(offs[-1])
        D = len(counts)
        qtok = self._qtok_host(queries)
        sl64 = np.asarray(sl, np.int64)
        el64 = np.asarray(el, np.int64)
        side64 = np.asarray(side, np.int64)
        # per-pattern field rows: SA-range lo, sl, el, three resolved q tokens
        pattab = np.zeros((bucket_size(max(D, 1)), 8), np.int32)
        pattab[:D, 0] = np.asarray(lo, np.int64)
        pattab[:D, 1] = sl64
        pattab[:D, 2] = el64
        if fwd:
            pattab[:D, 3] = qtok[side64]
            pattab[:D, 4] = qtok[side64 + 1]
            pattab[:D, 5] = qtok[side64 + 2]
        else:
            pattab[:D, 3] = qtok[side64 + sl64 - 1]
            pattab[:D, 4] = qtok[side64 + np.maximum(sl64 - 2, 0)]
            pattab[:D, 5] = qtok[side64 + np.maximum(sl64 - 3, 0)]
        offs_pad = np.full(len(pattab) + 1, offs[-1], np.int64)
        offs_pad[:D + 1] = offs
        pattab_d = self._put(pattab)
        offs_d = self._put(offs_pad.astype(np.int32))

        def _disp(s_, pat0_, n_call_):
            return _scan_batch_exp(
                ix.refstr_padded, ix.rlp, ix.lr_tar, ix.sa, pattab_d, offs_d,
                jnp.int32(s_), jnp.int32(pat0_), jnp.int32(D), ix.offs0,
                cfg.max_rule_span, cfg.min_gap_size, fwd, n_call_,
                do_gap=do_gap)

        pending = _expanded_dispatch(_disp, N, offs, SCAN_CHUNK,
                                     parallel=self._parallel)

        def _post():
            import jax
            parts = [np.asarray(jax.device_get(res)[0])[:ni]
                     for res, ni in pending]
            mask = np.concatenate(parts) if parts \
                else np.empty(0, np.int32)
            return (mask,)
        return _post() if fetch else Pending(_post)

    def _scan_expanded_cols(self, queries, fwd, lo, counts, sl, el, side,
                            fetch=True, do_gap=True):
        """Column-upload variant (CGX_SCAN_COLS=1 A/B diagnostic): 24 B/item
        H2D of host-resolved per-item fields."""
        from cgx_tpu.search.lookup import _scan_batch_cols
        ix, cfg = self.index, self.cfg
        item_pat, tx = materialize_items(counts)
        gostart = self.sa_host[np.asarray(lo, np.int64)[item_pat] + tx] \
            .astype(np.int32)
        qtok = self._qtok_host(queries)
        sl_i = np.asarray(sl, np.int64)[item_pat]
        el_i = np.asarray(el, np.int64)[item_pat]
        side_i = np.asarray(side, np.int64)[item_pat]
        if fwd:
            w0, w1, w2 = qtok[side_i], qtok[side_i + 1], qtok[side_i + 2]
        else:
            w0 = qtok[side_i + sl_i - 1]
            w1 = qtok[side_i + np.maximum(sl_i - 2, 0)]
            w2 = qtok[side_i + np.maximum(sl_i - 3, 0)]
        cols = [gostart, sl_i.astype(np.int32), el_i.astype(np.int32),
                w0, w1, w2]
        return chunked_batch(
            lambda *a: _scan_batch_cols(ix.refstr_padded, ix.rlp, ix.lr_tar,
                                        *(jnp.asarray(x) for x in a),
                                        ix.offs0, cfg.max_rule_span,
                                        cfg.min_gap_size, fwd, do_gap=do_gap),
            cols, chunk=SCAN_CHUNK, fetch=fetch, floor=SCAN_CHUNK // 8,
            parallel_compile=True)

    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode, fetch=True,
                     do_gap=True):
        import os
        if os.environ.get("CGX_SCAN_COLS"):
            return self._two_expanded_cols(onegap_sa, pc, lo, counts, pcmode,
                                           fetch, do_gap)
        from cgx_tpu.search.lookup import _two_batch_exp
        from cgx_tpu.utils.batching import bucket_size
        ix, cfg = self.index, self.cfg
        counts = np.asarray(counts, np.int64)
        offs = _offsets(counts)
        N = int(offs[-1])
        D = len(counts)
        ogcache = getattr(onegap_sa, "_dev_rows", None)
        if ogcache is None:
            ogcache = {}
            try:
                onegap_sa._dev_rows = ogcache
            except Exception:
                pass
        ogrows = ogcache.get(self.device)
        if ogrows is None:
            n_og = max(len(onegap_sa.str_position), 1)
            host = np.zeros((bucket_size(n_og), 2), np.int32)
            host[:len(onegap_sa.str_position), 0] = onegap_sa.str_position
            host[:len(onegap_sa.length), 1] = onegap_sa.length
            ogrows = ogcache[self.device] = self._put(host)
        pcrows = self._pc_rows_dev(pc)
        pattab = np.zeros((bucket_size(max(D, 1)), 2), np.int32)
        pattab[:D, 0] = np.asarray(lo, np.int64)
        pattab[:D, 1] = np.asarray(pcmode, bool)
        offs_pad = np.full(len(pattab) + 1, offs[-1], np.int64)
        offs_pad[:D + 1] = offs
        pattab_d = self._put(pattab)
        offs_d = self._put(offs_pad.astype(np.int32))

        def _disp(s_, pat0_, n_call_):
            return _two_batch_exp(
                ix.refstr_padded, ix.rlp, ix.lr_tar, ogrows, pcrows, pattab_d,
                offs_d, jnp.int32(s_), jnp.int32(pat0_), jnp.int32(D),
                ix.offs0, cfg.max_rule_span, cfg.min_gap_size, n_call_,
                do_gap=do_gap)

        pending = _expanded_dispatch(_disp, N, offs, SCAN_CHUNK,
                                     parallel=self._parallel)

        def _post():
            import jax
            parts = [np.asarray(jax.device_get(res)[0])[:ni]
                     for res, ni in pending]
            comb = (np.concatenate(parts) if parts
                    else np.empty(0, np.uint32)).astype(np.uint32)
            return (comb & 0xFFFF).astype(np.int64), \
                ((comb >> 16) & 0xFFFF).astype(np.int64)
        return _post() if fetch else Pending(_post)

    def _two_expanded_cols(self, onegap_sa, pc, lo, counts, pcmode,
                           fetch=True, do_gap=True):
        """Column-upload variant (CGX_SCAN_COLS=1 A/B diagnostic)."""
        from cgx_tpu.search.lookup import _two_batch_packed
        ix, cfg = self.index, self.cfg
        item_pat, tx = materialize_items(counts)
        row = np.asarray(lo, np.int64)[item_pat] + tx
        pcm = np.asarray(pcmode, bool)[item_pat]
        og_sp = onegap_sa.str_position if len(onegap_sa.str_position) \
            else np.zeros(1, np.int32)
        og_len = onegap_sa.length if len(onegap_sa.length) \
            else np.zeros(1, np.int32)
        pc_sp = pc.onegap_start if len(pc.onegap_start) \
            else np.zeros(1, np.int32)
        pc_len = pc.onegap_length if len(pc.onegap_length) \
            else np.zeros(1, np.int32)
        css = np.where(pcm, pc_sp[np.clip(row, 0, len(pc_sp) - 1)],
                       og_sp[np.clip(row, 0, len(og_sp) - 1)])
        fes = np.where(pcm, pc_len[np.clip(row, 0, len(pc_len) - 1)],
                       og_len[np.clip(row, 0, len(og_len) - 1)])
        comb_p = chunked_batch(
            lambda *a: _two_batch_packed(ix.refstr_padded, ix.rlp, ix.lr_tar,
                                         *(jnp.asarray(x) for x in a),
                                         ix.offs0, cfg.max_rule_span,
                                         cfg.min_gap_size, do_gap=do_gap),
            [css.astype(np.int32), fes.astype(np.int32)],
            chunk=SCAN_CHUNK, fetch=False, floor=SCAN_CHUNK // 8,
            parallel_compile=True)

        def _post():
            comb = np.asarray(comb_p.get()[0], np.uint32)
            return (comb & 0xFFFF).astype(np.int64), \
                ((comb >> 16) & 0xFFFF).astype(np.int64)
        return _post() if fetch else Pending(_post)

    def gap_check(self, gostart, fwd, fetch=True):
        """Precompute gap-consistency windows (search.precompute._gc_batch):
        one packed uint32 bitmask per occurrence of which forward/backward
        moves pass the target-side gap check (decode: precompute.gc_bit)."""
        from cgx_tpu.search.precompute import _gc_batch
        ix, cfg = self.index, self.cfg
        return chunked_batch(
            lambda g: (_gc_batch(ix.rlp, ix.lr_tar, self._put(g), ix.offs0,
                                 cfg.max_rule_span, cfg.min_gap_size, fwd),),
            [np.asarray(gostart, np.int32)], fetch=fetch,
            parallel_compile=self._parallel)

    def contig(self, sa_pos, lm, fetch=True):
        from cgx_tpu.extract.device import _contig_batch
        ix, cfg = self.index, self.cfg
        return chunked_batch(
            lambda sp, lp: _contig_batch(
                ix.refstr_padded, ix.sa, ix.rlp, ix.lr_tar,
                self._put(sp), self._put(lp), ix.offs0,
                cfg.max_rule_span, cfg.max_rule_symbols),
            [np.asarray(sa_pos, np.int32), np.asarray(lm, np.int32)],
            fetch=fetch, parallel_compile=self._parallel)

    def onegap(self, css, fes, sls, els, fetch=True):
        from cgx_tpu.extract.device import _onegap_batch
        ix, cfg = self.index, self.cfg
        return chunked_batch(
            lambda *a: _onegap_batch(
                ix.refstr_padded, ix.rlp, ix.lr_tar,
                *(self._put(x) for x in a), ix.offs0,
                cfg.max_rule_span, cfg.max_rule_symbols),
            [np.asarray(css, np.int32), np.asarray(fes, np.int32),
             np.asarray(sls, np.int32), np.asarray(els, np.int32)],
            fetch=fetch, parallel_compile=self._parallel)

    def twogap(self, css, fes, ses, sls, els, cls, fetch=True):
        from cgx_tpu.extract.device import _twogap_batch
        ix, cfg = self.index, self.cfg
        return chunked_batch(
            lambda *a: _twogap_batch(
                ix.refstr_padded, ix.rlp, ix.lr_tar,
                *(self._put(x) for x in a), ix.offs0, cfg.max_rule_span),
            [np.asarray(css, np.int32), np.asarray(fes, np.int32),
             np.asarray(ses, np.int32), np.asarray(sls, np.int32),
             np.asarray(els, np.int32), np.asarray(cls, np.int32)],
            fetch=fetch, parallel_compile=self._parallel)
