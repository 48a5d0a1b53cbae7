"""North-star conformance: the device pipeline's grammars must be byte-identical to the
sequential oracle's (BASELINE.json: byte-identical grammars on the toy corpus)."""

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.oracle import pipeline as opl
from cgx_tpu import pipeline as tpl


def _inputs(toy_fixture):
    return (cp.read_lines(str(toy_fixture / "corpus.f")),
            cp.read_lines(str(toy_fixture / "corpus.e")),
            cp.read_lines(str(toy_fixture / "corpus.a")),
            cp.read_tokens(str(toy_fixture / "lex.txt")),
            cp.read_lines(str(toy_fixture / "query.f")))


@pytest.mark.parametrize("sample", [True, False])
def test_pipeline_matches_oracle_byte_identical(toy_fixture, sample):
    cfg = ExtractorConfig(precompute_count=30, is_sample=sample)
    args = _inputs(toy_fixture)
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    assert len(o.per_query_lines) == len(t.per_query_lines)
    for q, (lo, lt) in enumerate(zip(o.per_query_lines, t.per_query_lines)):
        assert lo == lt, (
            f"query {q}: first diff at line "
            f"{next(i for i, (a, b) in enumerate(zip(lo, lt)) if a != b)}:\n"
            f"oracle: {next(a for a, b in zip(lo, lt) if a != b)}\n"
            f"device: {next(b for a, b in zip(lo, lt) if a != b)}")


@pytest.mark.parametrize("mode", ["0", "1"])
def test_pipeline_gapcheck_modes_match_oracle(toy_fixture, monkeypatch, mode):
    """Force BOTH gap-check policies (two-phase and fused) on the toy corpus:
    the default (search.lookup._fused_gapcheck) is fused, which would leave
    the two-phase split untested."""
    monkeypatch.setenv("CGX_FUSED_GAPCHECK", mode)
    cfg = ExtractorConfig(precompute_count=30)
    args = _inputs(toy_fixture)
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    assert o.per_query_lines == t.per_query_lines


def test_pipeline_matches_oracle_on_adversarial_corpus():
    """Non-monotone alignments, 1:N/N:1 fan-out, ~30% unaligned
    (tools.make_bigcorpus.make_hard_corpus): the consistency-check kill paths
    (`consistent` ExtractPair.cu:103-133, checkBoundaryGap GappyLook.cu:43-126
    semantics) actually fire — and the pipeline must still be byte-identical
    to the oracle (VERDICT r2 weak #3)."""
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools.make_bigcorpus import make_hard_corpus, make_big_queries
    f_text, e_text, a_lines, lex_tokens = make_hard_corpus(400, vocab=200,
                                                           seed=11)
    q_lines = make_big_queries(f_text, 6, seed=3)
    cfg = ExtractorConfig(precompute_count=20)
    args = (f_text.split("\n"), e_text.split("\n"), a_lines, lex_tokens,
            q_lines)
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    assert o.per_query_lines == t.per_query_lines
    assert sum(len(x) for x in t.per_query_lines) > 0


def test_pipeline_matches_oracle_on_real_text(real_fixture):
    """Natural French-English parallel text with IBM-Model-1 grow-diag
    alignments (tools/make_realfixture.py): real word-order divergence
    (adjective postposition -> crossing links), NULL-aligned function words,
    1:N/N:1 fan-out, genuine Zipf vocabulary — the reference's own
    conformance story was a natural-language run (the hansards toy,
    README.md:57-77); this is the rebuild's equivalent (VERDICT r3 #7)."""
    d = real_fixture
    args = (cp.read_lines(str(d / "corpus.f")),
            cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")),
            cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))
    cfg = ExtractorConfig(precompute_count=20)
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    assert o.per_query_lines == t.per_query_lines
    assert sum(len(x) for x in t.per_query_lines) > 1000


def test_golden_real_hashes(real_fixture):
    """Freeze the real-text grammars (drift in both engines together still
    fails here)."""
    import hashlib
    import json
    import pathlib
    d = real_fixture
    golden = json.loads(
        (pathlib.Path(__file__).parent / "golden_real_hashes.json").read_text())
    cfg = ExtractorConfig(precompute_count=golden["precompute_count"])
    res = tpl.run_pipeline(
        cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
        cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
        cp.read_lines(str(d / "query.f")), cfg)
    for q, lines in enumerate(res.per_query_lines):
        h = hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()
        assert h == golden["sha256"][str(q)], f"query {q} grammar drifted"


def test_precompute_matches_oracle(toy_fixture):
    from cgx_tpu.preproc import suffix_array as sab
    from cgx_tpu.index import container as ic
    from cgx_tpu.oracle import search as se
    from cgx_tpu.search import precompute as pcx
    cfg = ExtractorConfig(precompute_count=30)
    f, e, a, lex_t, q = _inputs(toy_fixture)
    src = cp.load_source_corpus(f)
    tgt = cp.load_target_corpus(e)
    al = cp.load_alignment(a, src, tgt)
    lex = cp.load_lex_table(lex_t, src.vocab, tgt.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg)
    pc_o = se.precompute(src, sa, al, cfg)
    pc_t = pcx.precompute_tpu(idx, src, sa, cfg)
    np.testing.assert_array_equal(pc_t.frequent_list, pc_o.frequent_list)
    np.testing.assert_array_equal(pc_t.tok_len, pc_o.tok_len)
    np.testing.assert_array_equal(pc_t.index_start, pc_o.index_start)
    np.testing.assert_array_equal(pc_t.index_end, pc_o.index_end)
    np.testing.assert_array_equal(pc_t.onegap_start, pc_o.onegap_start)
    np.testing.assert_array_equal(pc_t.onegap_length, pc_o.onegap_length)
    np.testing.assert_array_equal(pc_t.feature_missing, pc_o.feature_missing)
    assert pc_t.count == pc_o.count > 0


def test_index_artifact_roundtrip(toy_fixture, tmp_path):
    """Persist + reload the corpus index; query results must be byte-identical."""
    cfg = ExtractorConfig(precompute_count=30)
    args = _inputs(toy_fixture)
    idx_dir = str(tmp_path / "idx")
    r1 = tpl.run_pipeline(*args, cfg, index_dir=idx_dir)   # builds + saves
    r2 = tpl.run_pipeline(*args, cfg, index_dir=idx_dir)   # loads
    assert "indexload" in r2.timing.buckets
    assert r1.per_query_lines == r2.per_query_lines


def test_golden_toy_hashes(toy_fixture):
    """Freeze the canonical toy grammars: any semantic drift in either engine
    fails here even if both engines drift together."""
    import hashlib
    import json
    import pathlib
    golden = json.loads(
        (pathlib.Path(__file__).parent / "golden_toy_hashes.json").read_text())
    cfg = ExtractorConfig(precompute_count=golden["precompute_count"])
    res = tpl.run_pipeline(*_inputs(toy_fixture), cfg)
    for q, lines in enumerate(res.per_query_lines):
        h = hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()
        assert h == golden["sha256"][str(q)], f"query {q} grammar drifted"


def test_deep_match_verbatim_queries():
    """Queries that quote a long corpus sentence VERBATIM drive the
    refinement search to depth ~ sentence length (the adversarial corpus
    stresses alignments, not match depth — VERDICT r4 weak #5): the pipeline
    must stay byte-identical to the oracle, and the refinement driver's host
    footprint must stay O(computed intervals) (sparse per-chunk records), not
    O(n_tokens x reached_depth)."""
    rng = np.random.default_rng(5)
    vocab = 300
    sents = []
    for i in range(60):
        L = 250 if i == 0 else int(rng.integers(4, 12))
        sents.append(rng.integers(0, vocab, size=L))
    f_lines = [" ".join(f"f{t}" for t in s) for s in sents]
    e_lines = [" ".join(f"e{t}" for t in s) for s in sents]
    a_lines = [" ".join(f"{j}-{j}" for j in range(len(s))) for s in sents]
    used = sorted({int(t) for s in sents for t in s})
    lex_tokens = []
    for t in used:
        lex_tokens += [f"f{t}", f"e{t}", "0.9000000", "0.9000000"]
    # one 250-token verbatim quote in a batch of ordinary short queries (the
    # realistic shape: most lanes die shallow, a few go to sentence depth)
    q_lines = [f_lines[0]] + f_lines[5:55]
    cfg = ExtractorConfig(precompute_count=20)
    args = (f_lines, e_lines, a_lines, lex_tokens, q_lines)
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    assert o.per_query_lines == t.per_query_lines
    assert sum(len(x) for x in t.per_query_lines) > 0

    # the refinement driver's record footprint: sparse vs the dense stack
    from cgx_tpu.preproc import suffix_array as sab
    from cgx_tpu.index import container as ic
    from cgx_tpu.search import passes
    src = cp.load_source_corpus(f_lines)
    tgt = cp.load_target_corpus(e_lines)
    al = cp.load_alignment(a_lines, src, tgt)
    lex = cp.load_lex_table(lex_tokens, src.vocab, tgt.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg)
    qs = cp.load_queries(q_lines, src.vocab)
    stats = {}
    p1, p2 = passes.refine_passes(idx, qs, stats=stats)
    assert int(p1.longestmatch.max()) >= 250       # the quote matched in full
    assert stats["max_depth"] >= 248
    n = qs.totaltokens
    items = len(p2.up)
    # each lane stores <= lm + chunk-overshoot intervals (x2 for up/down);
    # the old dense accumulation stored 2 * n * max_depth words
    assert stats["interval_words"] <= 2 * (2 * n + items
                                           + (passes.DEPTH_CHUNK_DEEP + 4) * n)
    assert stats["interval_words"] < 2 * n * stats["max_depth"] / 4
