"""Single-process multi-device query data parallelism (LocalDPEngine).

The reference saturates its one device with every kernel launch — grid dims
cover the whole chip (SuffixArray.cu:1374-1378, ExtractPair.cu:3361).  The
JAX analog must cover the whole HOST's device set from one process:
``LocalDPEngine`` replicates the corpus index once per local device and
splits every device stage's flat work-item axis into contiguous per-device
slices.  Each device runs the identical per-item kernel on its slice;
results concatenate back in item order, so grammars are byte-identical to
the single-device run **by construction** (every kernel is a pure per-item
map; test-enforced in tests/test_localdp.py).  Host stages (lexicon, MaxLex
accumulation, formatting) are unchanged.

This is the third scaling axis, composing the picture with:

* ``parallel.multihost`` — queries split across OS processes (each paying
  interpreter + index-load + program-cache fixed costs);
* ``parallel.sharded``  — the index itself split across devices, for corpora
  beyond one device's HBM (a 1.8x-constant-overhead layout, BASELINE.md).

LocalDP is the right layout when the index FITS one device and the host has
N of them: one interpreter, one index build, one compiled-program cache —
N devices' worth of kernel throughput.  Dispatches are issued back-to-back
(JAX dispatch is asynchronous), so the N devices execute concurrently; only
result fetches synchronize, and those ride the existing deferred-``Pending``
machinery.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu.engine import ReplicatedEngine
from cgx_tpu.types import Pass1Result, Pass2Result
from cgx_tpu.utils.batching import Pending


def clone_index(index, device):
    """A per-device replica of a GrammarIndex: every device array is
    committed to ``device`` (device_put from the existing buffers — a D2D
    copy, or free for the replica on the array's current device); host-side
    fields are shared by reference."""
    import jax
    repl = {"device": device}
    for f in dataclasses.fields(type(index)):
        v = getattr(index, f.name)
        if isinstance(v, jax.Array):
            repl[f.name] = jax.device_put(v, device)
    return dataclasses.replace(index, **repl)


class LocalDPEngine:
    """Data-parallel dispatch engine over N local devices (replicated index).

    Implements the same engine protocol as ``ReplicatedEngine`` (plus
    ``pass1``/``pass2``, which the pipeline routes through the engine so the
    search passes also fan out).  Item order is preserved: device k gets the
    k-th contiguous slice of the item (or pattern) axis and the merged
    result is the in-order concatenation — bitwise equal to a single-device
    dispatch of the same items.
    """

    parallel_dispatch_safe = True

    def __init__(self, index, sa_host: np.ndarray, cfg, n_devices: int = 0,
                 devices=None):
        import jax
        if devices is None:
            local = jax.local_devices()
            n = n_devices or len(local)
            if n > len(local):
                raise ValueError(
                    f"--dp-devices {n} exceeds the {len(local)} local "
                    f"devices visible to this process")
            devices = local[:n]
        self.devices = list(devices)
        self.indices = [clone_index(index, d) for d in self.devices]
        self.engines = [ReplicatedEngine(ix, sa_host, cfg, device=d)
                        for ix, d in zip(self.indices, self.devices)]
        self.index = self.indices[0]
        self.sa_host = sa_host
        self.cfg = cfg

    # ------------------------------------------------------------------
    # splitting + merging
    # ------------------------------------------------------------------

    def _item_spans(self, n: int):
        """Equal contiguous per-device spans of a flat item axis."""
        D = len(self.engines)
        if n <= 0:
            return []
        per = -(-n // D)
        return [(k, k * per, min((k + 1) * per, n))
                for k in range(D) if k * per < n]

    def _pattern_spans(self, counts):
        """Contiguous per-device spans of the PATTERN axis balanced by
        expanded item count (the *_expanded kernels' real work axis)."""
        counts = np.asarray(counts, np.int64)
        total = int(counts.sum())
        D = len(self.engines)
        if len(counts) == 0 or total <= 0:
            return []
        cum = np.cumsum(counts)
        bounds = [0]
        for k in range(1, D):
            b = int(np.searchsorted(cum, (total * k) // D, side="left"))
            bounds.append(max(b, bounds[-1]))
        bounds.append(len(counts))
        return [(k, bounds[k], bounds[k + 1])
                for k in range(D) if bounds[k] < bounds[k + 1]]

    @staticmethod
    def _merge(pends, fetch):
        """Concatenate per-device results column-wise, in device (= item)
        order."""
        def _post():
            parts = [p.get() for p in pends]
            parts = [p for p in parts if p is not None]
            if not parts:
                return None
            return [np.concatenate(cols) for cols in zip(*parts)]
        return _post() if fetch else Pending(_post)

    # ------------------------------------------------------------------
    # search passes (routed through the engine by the pipeline)
    # ------------------------------------------------------------------

    def refine_passes(self, queries):
        """Seeded interval-refinement pass 1/2 (the production default,
        passes.refine_passes) with each dispatch's lane axis split across
        the local devices; byte-identical by construction (per-lane pure
        map)."""
        import jax.numpy as jnp
        from cgx_tpu.search import passes
        from cgx_tpu.utils.batching import pad_items

        def dispatch(toks_p, sls_p, lo_p, hi_p, depth, dchunk):
            spans = self._item_spans(len(toks_p))
            jobs = []
            for k, s, e in spans:
                ix = self.indices[k]
                nreal, t_p, s_p, l_p, h_p = pad_items(
                    toks_p[s:e], sls_p[s:e], lo_p[s:e], hi_p[s:e])
                jobs.append((nreal, passes._refine_chunk_local(
                    ix.sa, ix.refstr_padded, ix.device_query_tokens(queries),
                    jnp.asarray(t_p), jnp.asarray(s_p), jnp.asarray(l_p),
                    jnp.asarray(h_p), jnp.int32(depth), depths=dchunk)))
            import jax
            fetched = jax.device_get([res for _, res in jobs])
            cols = [[np.asarray(x)[:nreal] for x in res]
                    for (nreal, _), res in zip(jobs, fetched)]
            return [np.concatenate(c) for c in zip(*cols)]

        ix0 = self.indices[0]
        return passes.drive_refinement(queries, ix0.reflen,
                                       ix0.seed_tables(), dispatch)

    def pass1(self, queries) -> Pass1Result:
        n = queries.totaltokens
        ends = np.array([queries.query_end(int(q))
                         for q in queries.tok_to_qry], dtype=np.int32)
        toks = np.arange(n, dtype=np.int32)
        suffixlens = ends - toks
        spans = self._item_spans(n)
        pends = [self.engines[k].pass1_items(
            queries, toks[s:e], suffixlens[s:e], fetch=False)
            for k, s, e in spans]
        lm, up, down, ffh, ffl, ffr = self._merge(pends, True)
        return Pass1Result(up=up, down=down, firstfindhit=ffh,
                           firstfindhitL=ffl, firstfindhitR=ffr,
                           longestmatch=lm)

    def pass2(self, queries, p1: Pass1Result) -> Pass2Result:
        from cgx_tpu.search.passes import pass2_work_items
        connectoffset, toks, matches = pass2_work_items(p1)
        if len(toks) == 0:
            return Pass2Result(connectoffset=connectoffset,
                               up=np.empty(0, np.int32),
                               down=np.empty(0, np.int32))
        LLs = p1.firstfindhitL[toks]
        MMs = p1.firstfindhit[toks]
        RRs = p1.firstfindhitR[toks]
        spans = self._item_spans(len(toks))
        pends = [self.engines[k].pass2_items(
            queries, toks[s:e], matches[s:e], LLs[s:e], MMs[s:e], RRs[s:e],
            fetch=False) for k, s, e in spans]
        up, down = self._merge(pends, True)
        return Pass2Result(connectoffset=connectoffset, up=up, down=down)

    # ------------------------------------------------------------------
    # engine protocol
    # ------------------------------------------------------------------

    def sa_values(self, rows) -> np.ndarray:
        return self.sa_host[np.asarray(rows, np.int64)].astype(np.int32)

    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok,
                     fetch=True):
        counts = np.asarray(counts, np.int64)
        spans = self._pattern_spans(counts)
        arrs = [np.asarray(a) for a in (base, counts, sl, el, tok, stok)]
        if len(spans) <= 1:
            return self.engines[0].pcs_expanded(queries, pc, *arrs,
                                                fetch=fetch)
        pends = [self.engines[k].pcs_expanded(
            queries, pc, *(a[s:e] for a in arrs), fetch=False)
            for k, s, e in spans]
        return self._merge(pends, fetch)

    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side,
                      fetch=True, do_gap=True):
        counts = np.asarray(counts, np.int64)
        spans = self._pattern_spans(counts)
        arrs = [np.asarray(a) for a in (lo, counts, sl, el, side)]
        if len(spans) <= 1:
            return self.engines[0].scan_expanded(queries, fwd, *arrs,
                                                 fetch=fetch, do_gap=do_gap)
        pends = [self.engines[k].scan_expanded(
            queries, fwd, *(a[s:e] for a in arrs), fetch=False,
            do_gap=do_gap) for k, s, e in spans]
        return self._merge(pends, fetch)

    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode, fetch=True,
                     do_gap=True):
        counts = np.asarray(counts, np.int64)
        spans = self._pattern_spans(counts)
        arrs = [np.asarray(a) for a in (lo, counts, pcmode)]
        if len(spans) <= 1:
            return self.engines[0].two_expanded(onegap_sa, pc, *arrs,
                                                fetch=fetch, do_gap=do_gap)
        pends = [self.engines[k].two_expanded(
            onegap_sa, pc, *(a[s:e] for a in arrs), fetch=False,
            do_gap=do_gap) for k, s, e in spans]
        return self._merge(pends, fetch)

    def gap_check(self, gostart, fwd, fetch=True):
        g = np.asarray(gostart, np.int32)
        spans = self._item_spans(len(g))
        if len(spans) <= 1:
            return self.engines[0].gap_check(g, fwd, fetch=fetch)
        pends = [self.engines[k].gap_check(g[s:e], fwd, fetch=False)
                 for k, s, e in spans]
        return self._merge(pends, fetch)

    def _fan_items(self, meth: str, arrays, fetch):
        arrays = [np.asarray(a) for a in arrays]
        spans = self._item_spans(len(arrays[0]))
        if len(spans) <= 1:
            return getattr(self.engines[0], meth)(*arrays, fetch=fetch)
        pends = [getattr(self.engines[k], meth)(
            *(a[s:e] for a in arrays), fetch=False) for k, s, e in spans]
        return self._merge(pends, fetch)

    def contig(self, sa_pos, lm, fetch=True):
        return self._fan_items("contig", (sa_pos, lm), fetch)

    def onegap(self, css, fes, sls, els, fetch=True):
        return self._fan_items("onegap", (css, fes, sls, els), fetch)

    def twogap(self, css, fes, ses, sls, els, cls, fetch=True):
        return self._fan_items("twogap", (css, fes, ses, sls, els, cls),
                               fetch)
