"""Edge-case conformance: crafted inputs where the reference semantics have sharp
corners (empty queries, all-OOV queries, near-uint8-limit sentences, queries equal
to full corpus sentences).  Oracle and device pipeline must stay byte-identical."""

import numpy as np
import pytest

from cgx_tpu.config import ExtractorConfig
from cgx_tpu.oracle import pipeline as opl
from cgx_tpu import pipeline as tpl


def _world():
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(40)]
    f_lines = [" ".join(rng.choice(words, size=int(rng.integers(3, 10))))
               for _ in range(60)]
    # a long sentence near the alignment uint8 limit (positions < 255)
    long_f = " ".join(rng.choice(words, size=250))
    f_lines.append(long_f)
    e_lines = [" ".join("t" + w[1:] for w in ln.split()) for ln in f_lines]
    a_lines = [" ".join(f"{i}-{i}" for i in range(len(ln.split())))
               for ln in f_lines]
    lex_tokens = []
    for w in words:
        lex_tokens += [w, "t" + w[1:], "0.5", "0.5"]
        lex_tokens += ["NULL", "t" + w[1:], "0.1", "0.1"]
        lex_tokens += [w, "NULL", "0.1", "0.1"]
    q_lines = [
        f_lines[0],                       # ordinary
        "",                               # empty query
        "zz1 zz2 zz3",                    # all OOV
        f_lines[5],                       # exact corpus sentence
        " ".join(f_lines[3].split()[:2]) + " zzOOV " +
        " ".join(f_lines[9].split()[:3]),  # OOV splits patterns
        long_f.split()[0] + " " + long_f.split()[1],
    ]
    return f_lines, e_lines, a_lines, lex_tokens, q_lines


def test_edge_world_byte_identical():
    cfg = ExtractorConfig(precompute_count=10)
    args = _world()
    o = opl.run_oracle(*args, cfg)
    t = tpl.run_pipeline(*args, cfg)
    for q in range(len(args[4])):
        assert o.per_query_lines[q] == t.per_query_lines[q], f"query {q}"
    # empty + all-OOV queries produce empty grammars
    assert o.per_query_lines[1] == []
    assert o.per_query_lines[2] == []
    # ordinary queries produce rules
    assert len(o.per_query_lines[0]) > 0


def test_capacity_overflow_is_reported():
    """cap_* knobs are real checked ceilings (SURVEY.md section 5): exceeding
    one raises CapacityError naming the stage, never silent overflow."""
    from cgx_tpu.config import CapacityError
    cfg = ExtractorConfig(precompute_count=10, cap_onegap_enum=1)
    args = _world()
    with pytest.raises(CapacityError, match="onegap_enum"):
        tpl.run_pipeline(*args, cfg)


def test_overlap_mode_byte_identical():
    """Pipeline-overlap mode (batched queries, host half on a worker thread)
    must reproduce the single-batch grammars per query exactly."""
    cfg = ExtractorConfig(precompute_count=10)
    args = _world()
    base = tpl.run_pipeline(*args, cfg)
    ov = tpl.run_pipeline_overlap(*args, cfg, query_batches=3)
    assert base.counters["total_lines"] == ov.counters["total_lines"]
    for q in range(len(args[4])):
        assert base.per_query_lines[q] == ov.per_query_lines[q], f"query {q}"
