"""Device pass-1/pass-2 must be bit-identical to the sequential oracle."""

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.index import container as ic
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu.oracle import search as se
from cgx_tpu.search import passes


def _world(toy_fixture):
    cfg = ExtractorConfig(precompute_count=30)
    src = cp.load_source_corpus(cp.read_lines(str(toy_fixture / "corpus.f")))
    tgt = cp.load_target_corpus(cp.read_lines(str(toy_fixture / "corpus.e")))
    al = cp.load_alignment(cp.read_lines(str(toy_fixture / "corpus.a")), src, tgt)
    lex = cp.load_lex_table(cp.read_tokens(str(toy_fixture / "lex.txt")),
                            src.vocab, tgt.vocab)
    qs = cp.load_queries(cp.read_lines(str(toy_fixture / "query.f")), src.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg)
    return cfg, src, tgt, al, lex, qs, sa, idx


def test_pass1_pass2_match_oracle(toy_fixture):
    cfg, src, tgt, al, lex, qs, sa, idx = _world(toy_fixture)
    o1 = se.pass1(src, sa, qs)
    t1 = passes.pass1_tpu(idx, qs)
    np.testing.assert_array_equal(t1.longestmatch, o1.longestmatch)
    np.testing.assert_array_equal(t1.up, o1.up)
    np.testing.assert_array_equal(t1.down, o1.down)
    np.testing.assert_array_equal(t1.firstfindhit, o1.firstfindhit)
    np.testing.assert_array_equal(t1.firstfindhitL, o1.firstfindhitL)
    np.testing.assert_array_equal(t1.firstfindhitR, o1.firstfindhitR)

    o2 = se.pass2(src, sa, qs, o1)
    t2 = passes.pass2_tpu(idx, qs, t1)
    np.testing.assert_array_equal(t2.connectoffset, o2.connectoffset)
    np.testing.assert_array_equal(t2.up, o2.up)
    np.testing.assert_array_equal(t2.down, o2.down)


def test_refine_passes_match_oracle(toy_fixture):
    """The seeded interval-refinement engine (the production default) must
    produce the oracle's semantic pass-1/2 outputs exactly (firstfindhit*
    are search-path internals, reported as -1 by construction)."""
    cfg, src, tgt, al, lex, qs, sa, idx = _world(toy_fixture)
    o1 = se.pass1(src, sa, qs)
    r1, r2 = passes.refine_passes(idx, qs)
    np.testing.assert_array_equal(r1.longestmatch, o1.longestmatch)
    np.testing.assert_array_equal(r1.up, o1.up)
    np.testing.assert_array_equal(r1.down, o1.down)
    o2 = se.pass2(src, sa, qs, o1)
    np.testing.assert_array_equal(r2.connectoffset, o2.connectoffset)
    np.testing.assert_array_equal(r2.up, o2.up)
    np.testing.assert_array_equal(r2.down, o2.down)


def test_refine_passes_match_oracle_adversarial():
    """Refinement vs oracle on the adversarial generator (long sentences,
    Zipf vocab, OOV queries) — exercises deep ladders and empty buckets."""
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools.make_bigcorpus import make_hard_corpus, make_big_queries
    f_text, e_text, a_lines, lex_tokens = make_hard_corpus(200, vocab=120,
                                                           seed=7)
    cfg = ExtractorConfig(precompute_count=10)
    src = cp.load_source_corpus(f_text.split("\n"))
    tgt = cp.load_target_corpus(e_text.split("\n"))
    al = cp.load_alignment(a_lines, src, tgt)
    lex = cp.load_lex_table(lex_tokens, src.vocab, tgt.vocab)
    q_lines = make_big_queries(f_text, 8, seed=5) + ["zzz-oov qqq-oov"]
    qs = cp.load_queries(q_lines, src.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg)
    o1 = se.pass1(src, sa, qs)
    r1, r2 = passes.refine_passes(idx, qs)
    np.testing.assert_array_equal(r1.longestmatch, o1.longestmatch)
    np.testing.assert_array_equal(r1.up, o1.up)
    np.testing.assert_array_equal(r1.down, o1.down)
    o2 = se.pass2(src, sa, qs, o1)
    np.testing.assert_array_equal(r2.connectoffset, o2.connectoffset)
    np.testing.assert_array_equal(r2.up, o2.up)
    np.testing.assert_array_equal(r2.down, o2.down)
