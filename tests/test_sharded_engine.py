"""Fully-sharded index engine (parallel.sharded): bit-equality with the
replicated single-device path on the virtual 8-device CPU mesh, end to end.

This is the beyond-HBM mode: no O(corpus) replicated device array, no host-SA
read in the query path (SURVEY.md section 2.3 "index sharding" row)."""

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu import pipeline as tpl
from cgx_tpu.search import passes
from cgx_tpu.index import container as ic
from cgx_tpu.parallel import sharded as shx

N_DEV = 8


@pytest.fixture(scope="module")
def world(toy_fixture):
    cfg = ExtractorConfig(precompute_count=30)
    f = cp.read_lines(str(toy_fixture / "corpus.f"))
    e = cp.read_lines(str(toy_fixture / "corpus.e"))
    a = cp.read_lines(str(toy_fixture / "corpus.a"))
    lex = cp.read_tokens(str(toy_fixture / "lex.txt"))
    q = cp.read_lines(str(toy_fixture / "query.f"))
    src = cp.load_source_corpus(f)
    tgt = cp.load_target_corpus(e)
    al = cp.load_alignment(a, src, tgt)
    lext = cp.load_lex_table(lex, src.vocab, tgt.vocab)
    qs = cp.load_queries(q, src.vocab)
    sa = sab.build_index(src.str_)
    index = ic.build_index(src, tgt, sa, al, lext, cfg)
    sidx = shx.build_sharded_index(src, tgt, sa, al, cfg, n_devices=N_DEV)
    return dict(cfg=cfg, data=(f, e, a, lex, q), src=src, tgt=tgt, al=al,
                qs=qs, sa=sa, index=index, sidx=sidx)


def test_gather_sa_matches_host(world):
    sa_host = np.asarray(world["sa"].sa)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, len(sa_host), size=257).astype(np.int32)
    got = shx.gather_sa(world["sidx"], rows)
    np.testing.assert_array_equal(got, sa_host[rows])


def test_refinement_passes_bit_equal(world):
    p1_r = passes.pass1_tpu(world["index"], world["qs"])
    p2_r = passes.pass2_tpu(world["index"], world["qs"], p1_r)
    p1_s, p2_s = shx.sharded_passes(world["sidx"], world["qs"])
    np.testing.assert_array_equal(p1_s.longestmatch, p1_r.longestmatch)
    np.testing.assert_array_equal(p1_s.up, p1_r.up)
    np.testing.assert_array_equal(p1_s.down, p1_r.down)
    np.testing.assert_array_equal(p2_s.connectoffset, p2_r.connectoffset)
    np.testing.assert_array_equal(p2_s.up, p2_r.up)
    np.testing.assert_array_equal(p2_s.down, p2_r.down)
    assert p1_s.longestmatch.max() > 1   # the fixture exercises pass 2


@pytest.mark.parametrize("gapcheck", ["fused", "two-phase"])
def test_sharded_pipeline_byte_identical(world, monkeypatch, gapcheck):
    # "two-phase" forces the CGX_FUSED_GAPCHECK=0 policy so
    # ShardedEngine.gap_check on the query-path anchors keeps CI coverage
    # (the default fuses)
    monkeypatch.setenv("CGX_FUSED_GAPCHECK",
                       "1" if gapcheck == "fused" else "0")
    cfg = world["cfg"]
    f, e, a, lex, q = world["data"]
    rep = tpl.run_pipeline(f, e, a, lex, q, cfg)
    shd = tpl.run_pipeline(f, e, a, lex, q, cfg, sa_shards=N_DEV)
    assert rep.counters == shd.counters
    for i, (lr, ls) in enumerate(zip(rep.per_query_lines,
                                     shd.per_query_lines)):
        assert lr == ls, f"query {i}"


def test_sharded_build_never_replicates(world, monkeypatch, tmp_path):
    """``build_artifact(sa_shards>0)`` must not materialize a replicated
    O(corpus) device index anywhere — including the one-time precompute pass
    (VERDICT r2 missing #3; reference analog: the whole build fits the device
    budget, Start.cu:496).  Proven by making the replicated builder explode."""
    cfg = world["cfg"]
    f, e, a, lex, q = world["data"]

    def boom(*args, **kwargs):
        raise AssertionError("replicated device index built in sharded mode")
    monkeypatch.setattr(ic, "build_index", boom)
    monkeypatch.setattr(tpl.ic, "build_index", boom)
    art, index, t, shc, _ = tpl.build_artifact(f, e, a, lex, cfg,
                                               sa_shards=N_DEV)
    assert index is None and shc is not None
    # the sharded-build precompute is bit-identical to the replicated build's
    pc = art.precomp
    from cgx_tpu.search import precompute as pcx
    pc_rep = pcx.precompute_tpu(world["index"], world["src"], world["sa"], cfg)
    np.testing.assert_array_equal(pc.onegap_start, pc_rep.onegap_start)
    np.testing.assert_array_equal(pc.onegap_length, pc_rep.onegap_length)
    np.testing.assert_array_equal(pc.index_start, pc_rep.index_start)
    np.testing.assert_array_equal(pc.index_end, pc_rep.index_end)
    np.testing.assert_array_equal(pc.feature_missing, pc_rep.feature_missing)
    # and the full sharded pipeline runs to completion under the monkeypatch
    shd = tpl.run_pipeline(f, e, a, lex, q, cfg, sa_shards=N_DEV)
    assert shd.counters["total_lines"] > 0


def test_memory_per_device_is_sharded(world):
    per = world["sidx"].memory_per_device()
    # each device holds well under half of the replicated-index footprint
    # (halos dominate at toy scale; at real scale the ratio approaches 1/S)
    assert per["total"] < per["replicated_equiv"]
    assert per["sa"] * N_DEV <= 4 * (world["src"].toklen + N_DEV * 4)
