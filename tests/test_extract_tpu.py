"""Device extraction kernels must be bit-identical to the sequential oracle."""

import copy
import dataclasses

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.index import container as ic
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu.oracle import extract as oex
from cgx_tpu.oracle import search as se
from cgx_tpu.extract import device as dev
from cgx_tpu.extract.blocks import generate_blocks


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
    onegap_sa = se.one_gap_lookup(src, sa, al, qs, p1, p2, search1, pc, cfg)
    enum2, search2 = se.sort_and_dedup_twogap(
        se.two_gap_enumeration(qs, p1, enum1, search1, cfg), qs)
    twogap_sa = se.two_gap_lookup(src, al, qs, search1, onegap_sa, search2,
                                  pc, cfg)
    blocks = generate_blocks(sa, qs, p1, p2)
    return dict(cfg=cfg, src=src, tgt=tgt, al=al, qs=qs, sa=sa, idx=idx,
                pc=pc, p1=p1, p2=p2, search1=search1, onegap_sa=onegap_sa,
                search2=search2, twogap_sa=twogap_sa, blocks=blocks)


def _eq_gaprules(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


def test_contiguous_extraction_matches_oracle(world):
    w = world
    c_o, r1_o, r2_o = oex.extract_contiguous(w["src"], w["sa"], w["al"],
                                             w["blocks"], w["cfg"])
    c_t, r1_t, r2_t = dev.extract_contiguous_tpu(w["idx"], w["blocks"], w["cfg"])
    np.testing.assert_array_equal(c_t.blocknumber, c_o.blocknumber)
    np.testing.assert_array_equal(c_t.tar_start, c_o.tar_start)
    np.testing.assert_array_equal(c_t.tar_end, c_o.tar_end)
    _eq_gaprules(r1_t, r1_o)
    _eq_gaprules(r2_t, r2_o)
    assert len(c_o.blocknumber) > 0 and len(r1_o.gappy_index) > 0


def test_onegap_extraction_matches_oracle(world):
    w = world
    r1_o, r2_o = oex.extract_onegap(w["src"], w["al"], w["search1"],
                                    w["onegap_sa"], w["pc"], w["cfg"])
    r1_t, r2_t = dev.extract_onegap_tpu(w["idx"], w["search1"], w["onegap_sa"],
                                        w["pc"], w["cfg"])
    _eq_gaprules(r1_t, r1_o)
    _eq_gaprules(r2_t, r2_o)
    assert len(r1_o.gappy_index) > 0


def test_twogap_extraction_matches_oracle(world):
    w = world
    r_o = oex.extract_twogap(w["src"], w["al"], w["search1"], w["search2"],
                             w["twogap_sa"], w["cfg"])
    r_t = dev.extract_twogap_tpu(w["idx"], w["search1"], w["search2"],
                                 w["twogap_sa"], w["cfg"])
    _eq_gaprules(r_t, r_o)
    assert len(r_o.gappy_index) > 0
