"""Single-process multi-device query-DP (parallel.localdp): the FULL pipeline
fans every device stage's work items over N local devices with a replicated
per-device index, byte-identical to the single-device run (virtual 8-device
CPU mesh).

The reference's analog is one kernel launch covering the whole chip
(SuffixArray.cu:1374-1378); LocalDP covers the whole host's device set."""

import numpy as np
import pytest

import jax

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu import pipeline as tpl
from cgx_tpu.index import container as ic
from cgx_tpu.parallel.localdp import LocalDPEngine, clone_index


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
    return dict(cfg=cfg, data=(f, e, a, lex, q), src=src, qs=qs, sa=sa,
                index=index)


def test_clone_index_commits_to_device(world):
    devs = jax.local_devices()
    assert len(devs) >= 2
    rep = clone_index(world["index"], devs[1])
    assert rep.device is devs[1]
    assert rep.sa.devices() == {devs[1]}
    assert rep.refstr_padded.devices() == {devs[1]}
    # host fields are shared, not copied
    assert rep.lex_key is world["index"].lex_key
    np.testing.assert_array_equal(np.asarray(rep.sa),
                                  np.asarray(world["index"].sa))


def test_passes_bit_equal_across_dp(world):
    from cgx_tpu.search import passes
    qs, index, cfg = world["qs"], world["index"], world["cfg"]
    p1_r = passes.pass1_tpu(index, qs)
    p2_r = passes.pass2_tpu(index, qs, p1_r)
    eng = LocalDPEngine(index, np.asarray(world["sa"].sa), cfg, n_devices=3)
    p1_d = eng.pass1(qs)
    p2_d = eng.pass2(qs, p1_d)
    np.testing.assert_array_equal(p1_d.longestmatch, p1_r.longestmatch)
    np.testing.assert_array_equal(p1_d.up, p1_r.up)
    np.testing.assert_array_equal(p1_d.down, p1_r.down)
    np.testing.assert_array_equal(p2_d.connectoffset, p2_r.connectoffset)
    np.testing.assert_array_equal(p2_d.up, p2_r.up)
    np.testing.assert_array_equal(p2_d.down, p2_r.down)
    assert p1_d.longestmatch.max() > 1   # the fixture exercises pass 2


@pytest.mark.parametrize("n_dev,gapcheck",
                         [(2, "fused"), (2, "two-phase"), (3, "fused")])
def test_localdp_pipeline_byte_identical(world, monkeypatch, n_dev, gapcheck):
    """dp=2 (even) and dp=3 (uneven splits) both reproduce the single-device
    grammars exactly; the forced two-phase case keeps CI coverage on
    LocalDPEngine.gap_check (the default policy fuses)."""
    monkeypatch.setenv("CGX_FUSED_GAPCHECK",
                       "1" if gapcheck == "fused" else "0")
    cfg = world["cfg"]
    f, e, a, lex, q = world["data"]
    rep = tpl.run_pipeline(f, e, a, lex, q, cfg)
    dp = tpl.run_pipeline(f, e, a, lex, q, cfg, dp_devices=n_dev)
    assert rep.counters == dp.counters
    for i, (lr, ld) in enumerate(zip(rep.per_query_lines,
                                     dp.per_query_lines)):
        assert lr == ld, f"query {i}"


def test_localdp_rejects_too_many_devices(world):
    with pytest.raises(ValueError, match="exceeds"):
        LocalDPEngine(world["index"], np.asarray(world["sa"].sa),
                      world["cfg"], n_devices=len(jax.local_devices()) + 1)


def test_localdp_cli_flag(toy_fixture, tmp_path):
    from cgx_tpu import cli
    import pathlib
    F = pathlib.Path(toy_fixture)
    base = [str(F / "corpus.f"), str(F / "query.f"), str(F / "corpus.e"),
            str(F / "corpus.a"), str(F / "lex.txt")]
    assert cli.main(base + [str(tmp_path / "g1")]) == 0
    assert cli.main(["--dp-devices", "2"] + base + [str(tmp_path / "g2")]) == 0
    a = sorted((tmp_path / "g1").glob("grammar.*"))
    b = sorted((tmp_path / "g2").glob("grammar.*"))
    assert len(a) > 0 and [p.name for p in a] == [p.name for p in b]
    assert [p.read_bytes() for p in a] == [p.read_bytes() for p in b]
    # the two layout flags are mutually exclusive
    rc = cli.main(["--dp-devices", "2", "--sa-shards", "2"] + base
                  + [str(tmp_path / "g3")])
    assert rc == 1
