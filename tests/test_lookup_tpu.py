"""Device gappy lookups must be bit-identical to the sequential oracle."""

import copy

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.index import container as ic
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu.oracle import search as se
from cgx_tpu.search import lookup as lk


@pytest.fixture(scope="module")
def world(toy_fixture):
    cfg = ExtractorConfig(precompute_count=30)
    src = cp.load_source_corpus(cp.read_lines(str(toy_fixture / "corpus.f")))
    tgt = cp.load_target_corpus(cp.read_lines(str(toy_fixture / "corpus.e")))
    al = cp.load_alignment(cp.read_lines(str(toy_fixture / "corpus.a")), src, tgt)
    lex = cp.load_lex_table(cp.read_tokens(str(toy_fixture / "lex.txt")),
                            src.vocab, tgt.vocab)
    qs = cp.load_queries(cp.read_lines(str(toy_fixture / "query.f")), src.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg)
    pc = se.precompute(src, sa, al, cfg)
    p1 = se.pass1(src, sa, qs)
    p2 = se.pass2(src, sa, qs, p1)
    enum1, search1 = se.sort_and_dedup_onegap(
        se.one_gap_enumeration(qs, p1, cfg), qs)
    return dict(cfg=cfg, src=src, tgt=tgt, al=al, qs=qs, sa=sa, idx=idx,
                pc=pc, p1=p1, p2=p2, enum1=enum1, search1=search1)


def _assert_gaponsa_equal(a, b):
    np.testing.assert_array_equal(a.position, b.position)
    np.testing.assert_array_equal(a.str_position, b.str_position)
    np.testing.assert_array_equal(a.length, b.length)
    np.testing.assert_array_equal(a.length2, b.length2)


def test_onegap_lookup_matches_oracle(world):
    w = world
    s_oracle = copy.deepcopy(w["search1"])
    s_tpu = copy.deepcopy(w["search1"])
    og_o = se.one_gap_lookup(w["src"], w["sa"], w["al"], w["qs"], w["p1"],
                             w["p2"], s_oracle, w["pc"], w["cfg"])
    og_t = lk.one_gap_lookup_tpu(w["idx"], np.asarray(w["sa"].sa), w["qs"],
                                 w["p1"], w["p2"], s_tpu, w["pc"], w["cfg"])
    _assert_gaponsa_equal(og_o, og_t)
    np.testing.assert_array_equal(s_oracle.start_on_salist, s_tpu.start_on_salist)
    np.testing.assert_array_equal(s_oracle.end_on_salist, s_tpu.end_on_salist)
    assert len(og_o.position) > 0


def test_twogap_lookup_matches_oracle(world):
    w = world
    s1 = copy.deepcopy(w["search1"])
    og = se.one_gap_lookup(w["src"], w["sa"], w["al"], w["qs"], w["p1"],
                           w["p2"], s1, w["pc"], w["cfg"])
    enum2, search2_o = se.sort_and_dedup_twogap(
        se.two_gap_enumeration(w["qs"], w["p1"], w["enum1"], s1, w["cfg"]),
        w["qs"])
    search2_t = copy.deepcopy(search2_o)
    tg_o = se.two_gap_lookup(w["src"], w["al"], w["qs"], s1, og, search2_o,
                             w["pc"], w["cfg"])
    tg_t = lk.two_gap_lookup_tpu(w["idx"], w["qs"], s1, og, search2_t,
                                 w["pc"], w["cfg"])
    _assert_gaponsa_equal(tg_o, tg_t)
    np.testing.assert_array_equal(search2_o.start_on_salist,
                                  search2_t.start_on_salist)
    np.testing.assert_array_equal(search2_o.end_on_salist,
                                  search2_t.end_on_salist)
    assert len(tg_o.position) > 0
