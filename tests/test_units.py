"""Unit tests for the dispatch/packing machinery introduced by the
transfer-optimization work: emission-family packing, hit expansion,
global->local offset views, and chunk planning."""

import numpy as np
import jax.numpy as jnp

from cgx_tpu.engine import expand_hits, _offsets
from cgx_tpu.extract.device import _pack_family, unpack_family
from cgx_tpu.utils.batching import chunk_plan, chunked_indices, bucket_size
from cgx_tpu.utils.views import OffsetView


def test_pack_family_roundtrip():
    rng = np.random.default_rng(0)
    n = 257
    v = rng.random(n) < 0.5
    ts = rng.integers(0, 1 << 28, n).astype(np.int32)
    te = ts + rng.integers(0, 15, n)
    g1s = ts + rng.integers(0, 15, n)
    g1e = ts + rng.integers(0, 15, n)
    g2s = ts + rng.integers(0, 15, n)
    g2e = ts + rng.integers(0, 15, n)
    o_ts, pk = _pack_family(jnp.asarray(v), jnp.asarray(ts), jnp.asarray(te),
                            jnp.asarray(g1s), jnp.asarray(g1e),
                            jnp.asarray(g2s), jnp.asarray(g2e))
    uv, uts, ute, ug1s, ug1e, ug2s, ug2e = unpack_family(
        np.asarray(o_ts), np.asarray(pk), two_gaps=True)
    np.testing.assert_array_equal(uv, v)
    np.testing.assert_array_equal(uts, ts)
    # offsets only defined where valid (masked to 0 otherwise)
    np.testing.assert_array_equal(ute[v], te[v])
    np.testing.assert_array_equal(ug1s[v], g1s[v])
    np.testing.assert_array_equal(ug1e[v], g1e[v])
    np.testing.assert_array_equal(ug2s[v], g2s[v])
    np.testing.assert_array_equal(ug2e[v], g2e[v])
    np.testing.assert_array_equal(ute[~v], ts[~v])


def test_expand_hits_matches_repeat():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 7, 50)
    ids = rng.integers(100, 200, 50)
    item_pat = np.repeat(ids, counts)
    offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tx_all = np.arange(counts.sum()) - np.repeat(offs, counts)
    hits = np.flatnonzero(rng.random(int(counts.sum())) < 0.3)
    pat, tx, pi = expand_hits(hits, counts, ids)
    np.testing.assert_array_equal(pat, item_pat[hits])
    np.testing.assert_array_equal(tx, tx_all[hits])
    assert _offsets(counts)[-1] == counts.sum()


def test_offset_view_matches_global():
    g = np.arange(1000, dtype=np.int32) * 3
    off = 100
    local = jnp.asarray(g[off:400])
    view = OffsetView(local, jnp.int32(off), jnp.int32(len(g)))
    assert view.shape[0] == len(g)
    idx = jnp.asarray([100, 150, 399, 250])
    np.testing.assert_array_equal(np.asarray(view[idx]), g[np.asarray(idx)])


def test_chunk_plan_covers_and_is_pow2():
    for n in (0, 1, 63, 64, 4095, 4096, 131072, 131073, 1_000_001):
        sizes = chunk_plan(n)
        assert sum(sizes) == n
        for sz in sizes[:-1]:
            assert sz & (sz - 1) == 0


def test_chunked_indices_item_div():
    # call returns one packed word per 32 items: the helper must slice and
    # concatenate packed outputs correctly, including the padded tail
    def call(start, n):
        g = start + np.arange(n)
        bits = (g % 5 == 0).astype(np.uint32)
        return (jnp.asarray(
            bits.reshape(-1, 32) << np.arange(32, dtype=np.uint32)).sum(
                axis=1, dtype=jnp.uint32),)
    N = 70000
    (words,) = chunked_indices(call, N, chunk=16384, item_div=32)
    got = ((np.asarray(words)[:, None] >> np.arange(32)) & 1).ravel()[:N]
    np.testing.assert_array_equal(got, (np.arange(N) % 5 == 0).astype(int))


def test_maxlex_device_probe_matches_host():
    # the chip probe (lexicographic pair binary search + masked maxes) must be
    # bit-equal to both host backends (dense direct-index and searchsorted)
    from cgx_tpu.features import maxlex as ml
    from cgx_tpu.features.lexicon import TaskArrays
    from cgx_tpu.config import DEFAULT_CONFIG
    from cgx_tpu.index.container import pack_lex_key

    rng = np.random.default_rng(7)
    NS, NT, LEX = 50, 60, 400
    keys = np.unique(pack_lex_key(
        rng.integers(-1, NS, LEX), rng.integers(-1, NT, LEX)))

    class Ix:
        pass

    ix = Ix()
    ix.lex_key = keys
    ix.lex_val1_host = rng.random(len(keys)).astype(np.float32)
    ix.lex_val2_host = rng.random(len(keys)).astype(np.float32)
    tgt = rng.integers(2, NT, 5000).astype(np.int32)
    ix.tgt_str_host = tgt
    ix.tgt_str = jnp.asarray(tgt)

    T = 700
    sp = rng.integers(-1, NS + 5, (T, 5)).astype(np.int32)
    sp[np.arange(5)[None, :] >= rng.integers(1, 6, T)[:, None]] = -99
    t0 = rng.integers(0, len(tgt) - 2, T).astype(np.int32)
    tend = rng.integers(0, 15, T).astype(np.int32)
    g1 = np.where(rng.random(T) < 0.5, rng.integers(0, 8, T), -1).astype(np.int32)
    g11 = np.where(g1 >= 0, g1 + rng.integers(0, 4, T), -1).astype(np.int32)
    g2 = np.where((g1 >= 0) & (rng.random(T) < 0.3),
                  g11 + 1 + rng.integers(0, 4, T), -1).astype(np.int32)
    g21 = np.where(g2 >= 0, g2 + rng.integers(0, 3, T), -1).astype(np.int32)
    ta = {"onegap": TaskArrays(src_pat=sp, t0=t0, tend=tend, g1=g1, g11=g11,
                               g2=g2, g21=g21),
          "twogap": ml_empty(), "contig": ml_empty()}

    class RT:
        def __init__(self, n):
            self.max_lex_fge = np.zeros(n, np.float32)
            self.max_lex_egf = np.zeros(n, np.float32)

        def __len__(self):
            return len(self.max_lex_fge)

    outs = {}
    for name, dev in (("host_dense", False), ("device", True)):
        r = RT(T)
        ml.compute_maxlex_tpu(ta, ix, r, RT(0), RT(0), DEFAULT_CONFIG,
                              use_device=dev)
        outs[name] = (r.max_lex_fge.copy(), r.max_lex_egf.copy())
    # device range mode (force by shrinking the dense limit; tables re-cached)
    old_dev = ml.DEV_DENSE_LIMIT
    try:
        ml.DEV_DENSE_LIMIT = 0
        ix._maxlex_dev = None
        del ix._maxlex_dev
        r = RT(T)
        ml.compute_maxlex_tpu(ta, ix, r, RT(0), RT(0), DEFAULT_CONFIG,
                              use_device=True)
        outs["device_range"] = (r.max_lex_fge.copy(), r.max_lex_egf.copy())
    finally:
        ml.DEV_DENSE_LIMIT = old_dev
        if hasattr(ix, "_maxlex_dev"):
            del ix._maxlex_dev
    old = ml.DENSE_LIMIT
    try:
        ml.DENSE_LIMIT = 0          # force the searchsorted host backend
        r = RT(T)
        ml.compute_maxlex_tpu(ta, ix, r, RT(0), RT(0), DEFAULT_CONFIG,
                              use_device=False)
        outs["host_sparse"] = (r.max_lex_fge.copy(), r.max_lex_egf.copy())
    finally:
        ml.DENSE_LIMIT = old
    for name in ("device", "device_range", "host_sparse"):
        np.testing.assert_array_equal(outs["host_dense"][0], outs[name][0])
        np.testing.assert_array_equal(outs["host_dense"][1], outs[name][1])


def ml_empty():
    from cgx_tpu.features.lexicon import TaskArrays
    z = np.empty(0, np.int32)
    return TaskArrays(src_pat=np.empty((0, 5), np.int32), t0=z, tend=z,
                      g1=z, g11=z, g2=z, g21=z)


def test_fuse_below_calibration(monkeypatch):
    """The gap-check policy is a fixed rule, not a timing probe: fused by
    default, whatever the batch size, so every process of a collective run
    picks the same kernels; CGX_FUSED_GAPCHECK=0 selects two-phase."""
    from cgx_tpu.search import lookup as lk
    monkeypatch.delenv("CGX_FUSED_GAPCHECK", raising=False)
    assert lk._fused_gapcheck() is True
    assert not hasattr(lk, "fuse_below")
    monkeypatch.setenv("CGX_FUSED_GAPCHECK", "0")
    assert lk._fused_gapcheck() is False
    monkeypatch.setenv("CGX_FUSED_GAPCHECK", "1")
    assert lk._fused_gapcheck() is True


def test_maxlex_neglog_canonical_zero():
    """-log10(1.0) is -0.0; the device accumulator must never see it (XLA
    may fold zeros+term to term, which would print '-0.000000').  _neglog
    canonicalizes +-0 -> +0 and maps non-positive probabilities to +inf."""
    from cgx_tpu.features.maxlex import _neglog
    out = _neglog(np.array([1.0, 0.5, 0.0, -0.5], np.float32))
    assert out[0].view(np.int32) == 0            # +0.0, not -0.0 (0x80000000)
    assert out[1] > 0 and np.isfinite(out[1])
    assert np.isinf(out[2]) and np.isinf(out[3])
