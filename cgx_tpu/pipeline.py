"""Device pipeline: the reference's 9-phase flow (Start.cu:489-629) with device stages.

Stage map (oracle equivalent in parentheses):
  pass1/pass2        -> search.passes          (oracle.search.pass1/2)
  precompute         -> search.precompute_tpu  (oracle.search.precompute)
  gap enumeration    -> host (oracle.search.one/two_gap_enumeration; tiny workload)
  gappy lookups      -> search.lookup          (oracle.search.one/two_gap_lookup)
  extraction         -> extract.device         (oracle.extract.*)
  lexicon build      -> shared host (features.lexicon)
  MaxLex             -> features.maxlex        (oracle.features.compute_maxlex)
  grammar write      -> shared host (grammar.writer)

Byte-identical grammars with the oracle are enforced by tests/test_conformance.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cgx_tpu.config import DEFAULT_CONFIG, ExtractorConfig, check_capacity
from cgx_tpu.preproc import corpus as cp
from cgx_tpu.preproc import suffix_array as sab
from cgx_tpu.index import container as ic
from cgx_tpu.search import passes, lookup
from cgx_tpu.search import precompute as pcx
from cgx_tpu.extract import device as xdev
from cgx_tpu.extract.blocks import generate_blocks
from cgx_tpu.features import lexicon as lx
from cgx_tpu.features import maxlex as ml
from cgx_tpu.grammar import writer as gw
from cgx_tpu.search import enumerate_fast as ef
from cgx_tpu.types import GapRules
from cgx_tpu.preproc import index_io
from cgx_tpu.utils.timing import PhaseTimer


def _concat_gaprules(a: GapRules, b: GapRules) -> GapRules:
    return GapRules(*[np.concatenate([getattr(a, f.name), getattr(b, f.name)])
                      for f in dataclasses.fields(GapRules)])


@dataclasses.dataclass
class PipelineResult:
    queries: cp.QuerySet
    per_query_lines: list
    counters: dict
    timing: PhaseTimer


def build_artifact(f_lines, e_lines, a_lines, lex_tokens,
                   cfg: ExtractorConfig = DEFAULT_CONFIG,
                   timing: PhaseTimer = None, index_dir: str = None,
                   sa_shards: int = 0):
    """One-time corpus preprocessing -> (artifact, device GrammarIndex,
    timing, sharded_ctx).  With ``index_dir``, loads a previously persisted
    artifact when present and persists a fresh build otherwise (build-once /
    query-many).

    ``sa_shards > 0``: the build NEVER materializes a replicated O(corpus)
    device array — the precompute gap checks run owner-computes on the
    sharded engine (reference analog: the whole build fits the device budget,
    Start.cu:496).  Returns the already-built (sidx, engine) as
    ``sharded_ctx`` so the query path reuses the device placement.

    ``sa_shards`` may also be the string "auto": the device-memory budget
    decides (utils.budget) — replicated when the index fits one device, else
    the smallest shard count whose slice fits.  With ``sa_shards == 0`` and
    an index that cannot fit, a one-line BudgetError names the minimum shard
    count instead of failing inside a JAX allocation."""
    import os
    from cgx_tpu.utils.budget import resolve_shards
    t = timing or PhaseTimer()
    if index_dir and os.path.exists(os.path.join(index_dir, "meta.json")):
        with t.phase("indexload"):
            art, _built_cfg = index_io.load(index_dir)
        sa_shards = resolve_shards(sa_shards, art.source.toklen,
                                   art.target.toklen, cfg)
        with t.phase("qrysin"):
            index = (None if sa_shards else
                     ic.build_index(art.source, art.target, art.sa, art.align,
                                    art.lex, cfg))
        return art, index, t, None, sa_shards
    with t.phase("refsin"):
        source = (cp.load_source_corpus_text(f_lines) if isinstance(f_lines, str)
                  else cp.load_source_corpus(f_lines))
        target = (cp.load_target_corpus_text(e_lines) if isinstance(e_lines, str)
                  else cp.load_target_corpus(e_lines))
        align = cp.load_alignment_fast(a_lines, source, target)
        lex = cp.load_lex_table(lex_tokens, source.vocab, target.vocab)
    sa_shards = resolve_shards(sa_shards, source.toklen, target.toklen, cfg)
    with t.phase("suffixarray"):
        sa = sab.build_index(source.str_)
    sharded_ctx = None
    if sa_shards:
        from cgx_tpu.parallel import sharded as shx
        with t.phase("qrysin"):
            sidx = shx.build_sharded_index(source, target, sa, align, cfg,
                                           n_devices=sa_shards)
            engine = shx.ShardedEngine(sidx, cfg)
        with t.phase("precompute"):
            pc = pcx.precompute_tpu(None, source, sa, cfg, engine=engine)
        index = None
        sharded_ctx = (sidx, engine)
    else:
        with t.phase("qrysin"):
            index = ic.build_index(source, target, sa, align, lex, cfg)
        with t.phase("precompute"):
            pc = pcx.precompute_tpu(index, source, sa, cfg)
    art = index_io.CorpusIndexArtifact(source=source, target=target,
                                       align=align, lex=lex, sa=sa, precomp=pc)
    import jax as _jax
    if index_dir and _jax.process_index() == 0:
        # multi-host composed builds run in lockstep on every process;
        # exactly one persists the artifact
        with t.phase("indexsave"):
            index_io.save(index_dir, art, cfg)
    return art, index, t, sharded_ctx, sa_shards


def run_pipeline(f_lines, e_lines, a_lines, lex_tokens, q_lines,
                 cfg: ExtractorConfig = DEFAULT_CONFIG,
                 timing: PhaseTimer = None, index_dir: str = None,
                 sa_shards: int = 0, dp_devices: int = 0) -> PipelineResult:
    """``sa_shards > 0`` runs the query path in sharded-index mode: every
    O(corpus) device array (SA, refstr, RLP, target spans) lives split across
    that many devices (parallel.sharded) for corpora beyond single-chip HBM;
    there is no replicated O(corpus) device array and no host-SA read anywhere
    in the query path (SA values come from distributed gathers).

    ``dp_devices > 1`` runs the query path data-parallel over that many LOCAL
    devices from this one process: the index is replicated per device and
    every device stage's work-item axis fans out (parallel.localdp);
    byte-identical to the single-device run."""
    art, index, t, shc, sa_shards = build_artifact(
        f_lines, e_lines, a_lines, lex_tokens, cfg, timing, index_dir,
        sa_shards=sa_shards)
    ctx = _make_context(art, index, t, cfg, sa_shards, sharded_ctx=shc,
                        dp_devices=dp_devices)
    with t.phase("qrysload"):
        queries = cp.load_queries(q_lines, art.source.vocab)
    front = _front_stages(ctx, queries, cfg, t)
    per_query_lines, counters = _back_stages(ctx, queries, front, cfg, t)
    return PipelineResult(queries=queries, per_query_lines=per_query_lines,
                          counters=counters, timing=t)


def _make_context(art, index, t, cfg, sa_shards, sharded_ctx=None,
                  dp_devices: int = 0):
    """Engine + index handles shared by every query batch."""
    ctx = dict(art=art, index=index, source=art.source, target=art.target,
               sa=art.sa, pc=art.precomp)
    if sa_shards:
        from cgx_tpu.parallel import sharded as shx
        with t.phase("qrysin"):
            if sharded_ctx is not None:
                sidx, engine = sharded_ctx   # built by build_artifact
            else:
                sidx = shx.build_sharded_index(art.source, art.target, art.sa,
                                               art.align, cfg,
                                               n_devices=sa_shards)
                engine = shx.ShardedEngine(sidx, cfg)
            ctx["engine"] = engine
            ctx["sidx"] = sidx
            ctx["lex_index"] = ic.build_host_lex_index(art.target, art.lex)
            ctx["sa_values"] = ctx["engine"].sa_values
    elif dp_devices and dp_devices > 1:
        from cgx_tpu.parallel.localdp import LocalDPEngine
        with t.phase("qrysin"):
            ctx["engine"] = LocalDPEngine(index, np.asarray(art.sa.sa), cfg,
                                          n_devices=dp_devices)
        ctx["sidx"] = None
        ctx["lex_index"] = index
        ctx["sa_values"] = None
    else:
        from cgx_tpu.engine import ReplicatedEngine
        ctx["engine"] = ReplicatedEngine(index, np.asarray(art.sa.sa), cfg)
        ctx["sidx"] = None
        ctx["lex_index"] = index
        ctx["sa_values"] = None
    return ctx


def _front_stages(ctx, queries, cfg, t):
    """Device-driven half: pass 1/2, enumerations, gappy lookups, extraction.
    Must run on the main thread (owns all JAX dispatch)."""
    index, engine = ctx["index"], ctx["engine"]
    source, sa, pc = ctx["source"], ctx["sa"], ctx["pc"]
    if ctx["sidx"] is not None:
        from cgx_tpu.parallel import sharded as shx
        with t.phase("kernel"):
            p1, p2 = shx.sharded_passes(ctx["sidx"], queries)
    elif hasattr(engine, "pass1"):
        # LocalDPEngine: the search passes fan over the local devices too
        import os
        if os.environ.get("CGX_LCP_PASSES"):   # A/B: transplanted LCP search
            with t.phase("kernel"):
                p1 = engine.pass1(queries)
            with t.phase("kernel2"):
                p2 = engine.pass2(queries, p1)
        else:
            with t.phase("kernel"):
                p1, p2 = engine.refine_passes(queries)
    else:
        import os
        if os.environ.get("CGX_LCP_PASSES"):   # A/B: transplanted LCP search
            with t.phase("kernel"):
                p1 = passes.pass1_tpu(index, queries)
            with t.phase("kernel2"):
                p2 = passes.pass2_tpu(index, queries, p1)
        else:
            with t.phase("kernel"):
                p1, p2 = passes.refine_passes(index, queries)
    with t.phase("enumeration"):
        enum1, search1 = ef.fast_sort_and_dedup_onegap(
            ef.fast_one_gap_enumeration(queries, p1, cfg), queries)
        check_capacity("onegap_enum", len(enum1.number), cfg.cap_onegap_enum)
    with t.phase("lookup1"):
        onegap_sa = lookup.one_gap_lookup_tpu(index, None, queries, p1, p2,
                                              search1, pc, cfg, engine=engine)
        check_capacity("onegap_sa", len(onegap_sa.position), cfg.cap_onegap_sa)
    with t.phase("enumeration"):
        enum2, search2 = ef.fast_sort_and_dedup_twogap(
            ef.fast_two_gap_enumeration(queries, p1, enum1, search1, cfg),
            queries)
        check_capacity("twogap_enum", len(enum2.number), cfg.cap_twogap_enum)
    with t.phase("lookup2"):
        twogap_sa = lookup.two_gap_lookup_tpu(index, queries, search1,
                                              onegap_sa, search2, pc, cfg,
                                              engine=engine,
                                              refstr_host=np.asarray(
                                                  source.str_))
        check_capacity("twogap_sa", len(twogap_sa.position), cfg.cap_twogap_sa)

    with t.phase("extractin"):
        blocks = generate_blocks(sa, queries, p1, p2,
                                 sa_values=ctx["sa_values"])
    with t.phase("extractkernel"):
        from cgx_tpu.utils.timing import StageMarks
        mk = StageMarks("extract")
        # dispatch all three kernels, then fetch: the round-trips overlap.
        # On the replicated engine the three dispatches also run on the
        # compile pool so their first-time program compiles/loads overlap;
        # the sharded engine's programs are
        # collectives, which must dispatch in deterministic order on every
        # process, so it stays serial there.
        from cgx_tpu.utils.batching import PARALLEL_COMPILE_OK
        if getattr(engine, "parallel_dispatch_safe", False) \
                and PARALLEL_COMPILE_OK:
            from cgx_tpu.utils.batching import compile_pool
            pool = compile_pool()
            fut_c = pool.submit(xdev.extract_contiguous_tpu, index, blocks,
                                cfg, engine=engine, defer=True)
            fut_t = pool.submit(xdev.extract_twogap_tpu, index, search1,
                                search2, twogap_sa, cfg, engine=engine,
                                defer=True)
            fin_o = xdev.extract_onegap_tpu(index, search1, onegap_sa, pc,
                                            cfg, engine=engine, defer=True)
            fin_c = fut_c.result()
            fin_t = fut_t.result()
        else:
            fin_c = xdev.extract_contiguous_tpu(index, blocks, cfg,
                                                engine=engine, defer=True)
            fin_t = xdev.extract_twogap_tpu(index, search1, search2,
                                            twogap_sa, cfg, engine=engine,
                                            defer=True)
            fin_o = xdev.extract_onegap_tpu(index, search1, onegap_sa, pc,
                                            cfg, engine=engine, defer=True)
        mk.mark("dispatch")
        contig, og_blocks, tg_blocks = fin_c()
        mk.mark("contig_fetch")
        tg_seeds = fin_t()
        mk.mark("twogap_fetch")
        og_seeds, tg_onegap = fin_o()
        mk.mark("onegap_fetch")
        mk.done()
    sep_onegap = len(og_blocks.gappy_index)
    rules1 = _concat_gaprules(og_blocks, og_seeds)
    sep1 = len(tg_blocks.gappy_index)
    sep2 = sep1 + len(tg_seeds.gappy_index)
    rules2 = _concat_gaprules(_concat_gaprules(tg_blocks, tg_seeds), tg_onegap)
    return dict(p1=p1, p2=p2, enum1=enum1, search1=search1,
                onegap_sa=onegap_sa, enum2=enum2, search2=search2,
                twogap_sa=twogap_sa, blocks=blocks, contig=contig,
                rules1=rules1, rules2=rules2, sep_onegap=sep_onegap,
                sep1=sep1, sep2=sep2)


def _back_stages(ctx, queries, fr, cfg, t):
    """Host-only half: lexicon build, MaxLex, rule formatting.  Thread-safe
    (numpy only), so the overlap mode runs it concurrently with the next
    batch's front half."""
    source, target, pc = ctx["source"], ctx["target"], ctx["pc"]
    lex_index = ctx["lex_index"]
    blocks, search1, enum1 = fr["blocks"], fr["search1"], fr["enum1"]
    search2, enum2 = fr["search2"], fr["enum2"]
    from concurrent.futures import ThreadPoolExecutor
    from cgx_tpu.utils.timing import StageMarks
    with t.phase("lexicon"):
        mk = StageMarks("lexicon")
        # the three families are independent and numpy's sorts/uniques release
        # the GIL, so they run concurrently (wins on multi-core hosts, no-op
        # semantically — results are per-family)
        with ThreadPoolExecutor(max_workers=2) as pool:
            f_one = pool.submit(
                lx.fast_create_lexicon_onegap, fr["rules1"], source, target,
                blocks, search1, enum1, fr["onegap_sa"], pc,
                fr["sep_onegap"], cfg)
            f_two = pool.submit(
                lx.fast_create_lexicon_twogap, fr["rules2"], source, target,
                blocks, search1, enum1, search2, enum2, fr["onegap_sa"], pc,
                fr["sep1"], fr["sep2"], cfg)
            rules_contig, tasks_contig = lx.fast_create_lexicon_contig(
                fr["contig"], source, target, blocks, cfg)
            rules_one, tasks_one = f_one.result()
            rules_two, tasks_two = f_two.result()
        mk.mark(f"families[{len(fr['rules1'].gappy_index)}+"
                f"{len(fr['rules2'].gappy_index)}+"
                f"{len(fr['contig'].blocknumber)}]")
        mk.done()
    with t.phase("maxlex"):
        ml.compute_maxlex_tpu(
            {"onegap": tasks_one, "twogap": tasks_two, "contig": tasks_contig},
            lex_index, rules_one, rules_two, rules_contig, cfg,
            use_device=ctx.get("maxlex_use_device"))

    with t.phase("printout"):
        mk = StageMarks("printout")
        G = len(blocks.start)
        D1 = len(search1.qrystart)
        D2 = len(search2.blockid)
        ud_contig = lx.updown_index(rules_contig, G)
        ud_one = lx.updown_index(rules_one, 2 * G + D1)
        ud_two = lx.updown_index(rules_two, G + D2 + 2 * D1)
        mk.mark("updown")
        fmt_contig = gw.format_lines(rules_contig)
        fmt_one = gw.format_lines(rules_one)
        fmt_two = gw.format_lines(rules_two)
        mk.mark(f"format[{len(rules_contig)}+{len(rules_one)}"
                f"+{len(rules_two)}]")
        per_query_lines = [
            gw.grammar_lines_for_query(
                q, blocks.qry_global, search1.query_with_id,
                search2.query_with_id, ud_contig, ud_one, ud_two,
                fmt_contig, fmt_one, fmt_two, G, D1, D2)
            for q in range(queries.qryscount)
        ]
        mk.mark("perquery")
        mk.done()
    counters = dict(
        blocks=G, distinct_onegap=D1, distinct_twogap=D2,
        pass1_tokens=queries.totaltokens, pass2_items=len(fr["p2"].up),
        onegap_sa=len(fr["onegap_sa"].position),
        twogap_sa=len(fr["twogap_sa"].position),
        contig_pairs=len(fr["contig"].blocknumber),
        onegap_rules=len(fr["rules1"].gappy_index),
        twogap_rules=len(fr["rules2"].gappy_index),
        distinct_rules=len(rules_one) + len(rules_two) + len(rules_contig),
        total_lines=sum(len(x) for x in per_query_lines))
    return per_query_lines, counters


def run_pipeline_overlap(f_lines, e_lines, a_lines, lex_tokens, q_lines,
                         cfg: ExtractorConfig = DEFAULT_CONFIG,
                         timing: PhaseTimer = None, index_dir: str = None,
                         sa_shards: int = 0, dp_devices: int = 0,
                         query_batches: int = 2) -> PipelineResult:
    """Pipeline-parallel analog (SURVEY.md section 2.3 PP row): queries split
    into contiguous batches; batch i's host-only back half (lexicon/MaxLex/
    formatting) runs on a worker thread WHILE batch i+1's device-driven front
    half dispatches — phase k of batch i overlaps phase k+1 of batch i-1.
    Byte-identical to the single-batch run per query (rule features are
    pattern-intrinsic, so batch composition cannot change any line — the same
    invariant the multi-host split relies on, enforced by tests)."""
    from concurrent.futures import ThreadPoolExecutor

    art, index, t, shc, sa_shards = build_artifact(
        f_lines, e_lines, a_lines, lex_tokens, cfg, timing, index_dir,
        sa_shards=sa_shards)
    ctx = _make_context(art, index, t, cfg, sa_shards, sharded_ctx=shc,
                        dp_devices=dp_devices)
    with t.phase("qrysload"):
        all_q = list(q_lines)
    B = max(1, min(query_batches, len(all_q)))
    per = -(-len(all_q) // B)
    chunks = [all_q[i:i + per] for i in range(0, len(all_q), per)]
    # the back half runs on a worker thread and must stay numpy-only (the main
    # thread owns all device dispatch), so MaxLex keeps its host backend here
    ctx["maxlex_use_device"] = False
    futs = []
    qsets = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for chunk in chunks:
            with t.phase("qrysload"):
                qb = cp.load_queries(chunk, art.source.vocab)
            qsets.append(qb)
            front = _front_stages(ctx, qb, cfg, t)
            futs.append(pool.submit(_back_stages, ctx, qb, front, cfg, t))
        outs = [f.result() for f in futs]
    per_query_lines = []
    counters: dict = {}
    # Counters sum across batches.  total_lines / *_rules / *_sa are true
    # totals;
    # the pattern-scoped statistics (blocks, distinct_*) double-count patterns
    # shared between batches — fine for throughput math, not for corpus
    # statistics.  ``per_batch`` keeps the exact per-batch dicts.
    for lines, cnt in outs:
        per_query_lines.extend(lines)
        for k, v in cnt.items():
            counters[k] = counters.get(k, 0) + v
    counters["query_batches"] = len(outs)
    counters["per_batch"] = [cnt for _, cnt in outs]
    queries = cp.load_queries(all_q, art.source.vocab)
    return PipelineResult(queries=queries, per_query_lines=per_query_lines,
                          counters=counters, timing=t)


def run_pipeline_files(reffile, qryfile, tarfile, alignfile, lexfile, dest_dir,
                       cfg: ExtractorConfig = DEFAULT_CONFIG,
                       index_dir: str = None, sa_shards: int = 0,
                       query_batches: int = 0, dp_devices: int = 0):
    with open(reffile, encoding="utf-8") as fh:
        f_text = fh.read()
    with open(tarfile, encoding="utf-8") as fh:
        e_text = fh.read()
    if query_batches > 1:
        res = run_pipeline_overlap(
            f_text, e_text, cp.read_lines(alignfile),
            cp.read_tokens(lexfile), cp.read_lines(qryfile), cfg,
            index_dir=index_dir, sa_shards=sa_shards, dp_devices=dp_devices,
            query_batches=query_batches)
    else:
        res = run_pipeline(
            f_text, e_text, cp.read_lines(alignfile),
            cp.read_tokens(lexfile), cp.read_lines(qryfile), cfg,
            index_dir=index_dir, sa_shards=sa_shards, dp_devices=dp_devices)
    gw.write_grammars(dest_dir, res.queries.qryscount, cfg.is_sample,
                      res.per_query_lines)
    import sys
    print(res.timing.report(), file=sys.stderr)
    print("counters:", res.counters, file=sys.stderr)
    return res
