"""End-to-end oracle pipeline: the 9-phase flow of start() (Start.cu:489-629),
sequential and exact.  Slow by design — the spec for the device pipeline."""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu.config import DEFAULT_CONFIG, ExtractorConfig
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu.oracle import extract as ex
from cgx_tpu.oracle import features as ft
from cgx_tpu.grammar import writer as gr
from cgx_tpu.oracle import search as se


@dataclasses.dataclass
class OracleResult:
    source: cp.SourceCorpus
    target: cp.TargetCorpus
    queries: cp.QuerySet
    sa: sab.SAIndex
    align: cp.Alignment
    p1: se.Pass1Result
    p2: se.Pass2Result
    enum1: se.OneGapEnum
    search1: se.OneGapSearch
    onegap_sa: se.GapOnSA
    enum2: se.TwoGapEnum
    search2: se.TwoGapSearch
    twogap_sa: se.GapOnSA
    precomp: se.Precomp
    blocks: ex.Blocks
    contig: ex.ContigRules
    rules_one: list
    rules_two: list
    rules_contig: list
    sep_onegap: int
    sep_twogap: tuple
    ud_contig: np.ndarray
    ud_one: np.ndarray
    ud_two: np.ndarray
    per_query_lines: list


def _concat_gaprules(a: ex.GapRules, b: ex.GapRules) -> ex.GapRules:
    return ex.GapRules(*[np.concatenate([getattr(a, f.name), getattr(b, f.name)])
                         for f in dataclasses.fields(ex.GapRules)])


def run_oracle(f_lines, e_lines, a_lines, lex_tokens, q_lines,
               cfg: ExtractorConfig = DEFAULT_CONFIG,
               use_native_sa: bool = True) -> OracleResult:
    source = cp.load_source_corpus(f_lines)
    target = cp.load_target_corpus(e_lines)
    align = cp.load_alignment(a_lines, source, target)
    lex = cp.load_lex_table(lex_tokens, source.vocab, target.vocab)
    queries = cp.load_queries(q_lines, source.vocab)
    sa = sab.build_index(source.str_, use_native=use_native_sa)

    # matching engine (suffixArraySearch, SuffixArray.cu:1342-2267)
    pc = se.precompute(source, sa, align, cfg)
    p1 = se.pass1(source, sa, queries)
    p2 = se.pass2(source, sa, queries, p1)
    enum1_raw = se.one_gap_enumeration(queries, p1, cfg)
    enum1, search1 = se.sort_and_dedup_onegap(enum1_raw, queries)
    onegap_sa = se.one_gap_lookup(source, sa, align, queries, p1, p2,
                                  search1, pc, cfg)
    enum2_raw = se.two_gap_enumeration(queries, p1, enum1, search1, cfg)
    enum2, search2 = se.sort_and_dedup_twogap(enum2_raw, queries)
    twogap_sa = se.two_gap_lookup(source, align, queries, search1, onegap_sa,
                                  search2, pc, cfg)

    # extraction (ExtractPairs_Large_Data_Gappy, ExtractPair.cu:3215-4001)
    blocks = ex.generate_blocks(sa, queries, p1, p2)
    contig, onegap_from_blocks, twogap_from_blocks = ex.extract_contiguous(
        source, sa, align, blocks, cfg)
    twogap_from_seeds = ex.extract_twogap(source, align, search1, search2,
                                          twogap_sa, cfg)
    onegap_from_seeds, twogap_from_onegap = ex.extract_onegap(
        source, align, search1, onegap_sa, pc, cfg)

    sep_onegap = len(onegap_from_blocks.gappy_index)
    rules1 = _concat_gaprules(onegap_from_blocks, onegap_from_seeds)
    sep1 = len(twogap_from_blocks.gappy_index)
    sep2 = sep1 + len(twogap_from_seeds.gappy_index)
    rules2 = _concat_gaprules(_concat_gaprules(twogap_from_blocks,
                                               twogap_from_seeds),
                              twogap_from_onegap)

    # features (createLexicon*Fast order: one-gap, two-gap, contiguous)
    tasks: list = []
    rules_one = ft.create_lexicon_onegap(rules1, source, target, blocks, search1,
                                         enum1, onegap_sa, pc, sep_onegap, cfg,
                                         tasks)
    rules_two = ft.create_lexicon_twogap(rules2, source, target, blocks, search1,
                                         enum1, search2, enum2, onegap_sa, pc,
                                         sep1, sep2, cfg, tasks)
    rules_contig = ft.create_lexicon_contig(contig, source, target, blocks, cfg,
                                            tasks)
    ft.compute_maxlex(tasks, target, lex, rules_one, rules_two, rules_contig, cfg)

    G = len(blocks.start)
    D1 = len(search1.qrystart)
    D2 = len(search2.blockid)
    ud_contig = ft.updown_index(rules_contig, G)
    ud_one = ft.updown_index(rules_one, 2 * G + D1)
    ud_two = ft.updown_index(rules_two, G + D2 + 2 * D1)

    from cgx_tpu.features.lexicon import RuleTable
    fmt_contig = gr.format_lines(RuleTable.from_fastspeed(rules_contig))
    fmt_one = gr.format_lines(RuleTable.from_fastspeed(rules_one))
    fmt_two = gr.format_lines(RuleTable.from_fastspeed(rules_two))
    per_query_lines = [
        gr.grammar_lines_for_query(
            q, blocks.qry_global, search1.query_with_id, search2.query_with_id,
            ud_contig, ud_one, ud_two, fmt_contig, fmt_one, fmt_two,
            G, D1, D2)
        for q in range(queries.qryscount)
    ]
    return OracleResult(
        source=source, target=target, queries=queries, sa=sa, align=align,
        p1=p1, p2=p2, enum1=enum1, search1=search1, onegap_sa=onegap_sa,
        enum2=enum2, search2=search2, twogap_sa=twogap_sa, precomp=pc,
        blocks=blocks, contig=contig, rules_one=rules_one, rules_two=rules_two,
        rules_contig=rules_contig, sep_onegap=sep_onegap,
        sep_twogap=(sep1, sep2), ud_contig=ud_contig, ud_one=ud_one,
        ud_two=ud_two, per_query_lines=per_query_lines)


def run_oracle_files(reffile, qryfile, tarfile, alignfile, lexfile, dest_dir,
                     cfg: ExtractorConfig = DEFAULT_CONFIG):
    res = run_oracle(
        cp.read_lines(reffile), cp.read_lines(tarfile), cp.read_lines(alignfile),
        cp.read_tokens(lexfile), cp.read_lines(qryfile), cfg)
    gr.write_grammars(dest_dir, res.queries.qryscount, cfg.is_sample,
                      res.per_query_lines)
    return res
