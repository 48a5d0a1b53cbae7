"""Long-lived serving mode: build/load the corpus index once, then answer
query batches until EOF.

The reference's closest analog is its persisted ``sa_precomp.txt`` reuse
(SuffixArray.c:208-230), which still relaunched the whole binary — and paid
the whole device-side setup — once per query batch.  Here the process keeps
the device-resident index, the compiled-program cache, and the engine context
across requests, so batch k>1 pays only its own query work (the warm-open
concurrency in utils.batching covers batch 1).

Protocol (stdin, one request per line):

    <query_file> <dest_dir>

writes ``dest_dir/grammar.<i>.{s,n}`` per query (identical bytes to a
one-shot ``cgx_tpu.cli`` run over the same corpus/queries — test-enforced)
and answers on stdout:

    ok <n_queries> <n_grammar_lines> <seconds>

Usage:
    python -m cgx_tpu.serve <source_corpus> <target_corpus> <alignment_file> \
        <lex_file> [--index-dir DIR] [--sa-shards N] [--no-sample] \
        [--prewarm QRYFILE]
"""

from __future__ import annotations

import argparse
import sys
import time

from cgx_tpu.config import DEFAULT_CONFIG


def serve_loop(reffile, tarfile, alignfile, lexfile, cfg=DEFAULT_CONFIG,
               index_dir=None, sa_shards: int = 0, dp_devices: int = 0,
               inp=None, out=None, prewarm="auto", prewarm_queries: int = 16):
    """Run the serve protocol over ``inp``/``out`` streams (stdin/stdout by
    default).  Returns the number of requests served.

    ``prewarm`` names a query file run through the full engine (output
    discarded) BEFORE ``ready`` is printed, so the first real request does
    not pay the first-touch compiled-program loads.  The default ``"auto"``
    synthesizes a batch of ``prewarm_queries`` queries from the corpus's own
    sentences (always in-vocab), which warms the dispatch programs that
    batch size reaches; the prewarm run's first-touch loads go through the
    shared compile pool (utils.batching), so distinct programs load
    CONCURRENTLY.  Deployments with large batches should set
    ``prewarm_queries`` (or pass a representative file) to their production
    batch size so the exact pow2 chunk-shape ladder
    (utils.batching.chunk_plan) compiles up front rather than on request 1.
    ``None`` disables prewarming."""
    from cgx_tpu import pipeline as tpl
    from cgx_tpu.preproc import corpus as cp
    from cgx_tpu.grammar import writer as gw
    from cgx_tpu.utils.timing import PhaseTimer

    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out

    with open(reffile, encoding="utf-8") as fh:
        f_text = fh.read()
    with open(tarfile, encoding="utf-8") as fh:
        e_text = fh.read()
    t0 = time.perf_counter()
    art, index, t, shc, sa_shards = tpl.build_artifact(
        f_text, e_text, cp.read_lines(alignfile), cp.read_tokens(lexfile),
        cfg, index_dir=index_dir, sa_shards=sa_shards)
    ctx = tpl._make_context(art, index, t, cfg, sa_shards, sharded_ctx=shc,
                            dp_devices=dp_devices)
    if prewarm is not None:
        # a bad prewarm file must not kill the server before 'ready':
        # orchestrators block on that line, and per-request errors are
        # already reported inline — treat prewarm failures the same way
        try:
            if prewarm == "auto":
                sents = [ln for ln in f_text.split("\n") if ln.strip()]
                reps = -(-max(prewarm_queries, 1) // max(len(sents), 1))
                q_lines = (sents * reps)[:prewarm_queries]
            else:
                q_lines = cp.read_lines(prewarm)
            wq = cp.load_queries(q_lines, art.source.vocab)
            wt = PhaseTimer()
            tpl._back_stages(ctx, wq, tpl._front_stages(ctx, wq, cfg, wt),
                             cfg, wt)
        except Exception as exc:
            print(f"warn prewarm failed {type(exc).__name__}: {exc}",
                  file=out, flush=True)
    print(f"ready {time.perf_counter() - t0:.3f}", file=out, flush=True)

    served = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            qryfile, dest = line.split()
        except ValueError:
            print(f"err bad request line: {line!r}", file=out, flush=True)
            continue
        t1 = time.perf_counter()
        try:
            queries = cp.load_queries(cp.read_lines(qryfile),
                                      art.source.vocab)
            bt = PhaseTimer()
            front = tpl._front_stages(ctx, queries, cfg, bt)
            lines, counters = tpl._back_stages(ctx, queries, front, cfg, bt)
            gw.write_grammars(dest, queries.qryscount, cfg.is_sample, lines)
        except Exception as exc:   # keep serving after a bad batch
            print(f"err {type(exc).__name__}: {exc}", file=out, flush=True)
            continue
        print(f"ok {queries.qryscount} {counters['total_lines']} "
              f"{time.perf_counter() - t1:.3f}", file=out, flush=True)
        served += 1
    return served


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cgx_tpu.serve", description=__doc__)
    p.add_argument("reffile")
    p.add_argument("reftargetfile")
    p.add_argument("alignfile")
    p.add_argument("lexfile")
    p.add_argument("--index-dir", default=None)
    p.add_argument("--sa-shards", type=int, default=0)
    p.add_argument("--dp-devices", type=int, default=0)
    p.add_argument("--no-sample", action="store_true")
    p.add_argument("--prewarm", default="auto", metavar="QRYFILE",
                   help="run this query batch (output discarded) before "
                        "printing ready, absorbing first-touch program "
                        "loads; should be representative of production "
                        "batch sizes so the same pow2 dispatch-chunk "
                        "programs get compiled (default: a small batch "
                        "synthesized from the corpus's own sentences)")
    p.add_argument("--no-prewarm", action="store_true",
                   help="disable the default prewarm batch")
    p.add_argument("--prewarm-queries", type=int, default=16, metavar="N",
                   help="auto-prewarm batch size; set to the production "
                        "batch size so its exact pow2 dispatch-chunk ladder "
                        "compiles (concurrently) before 'ready'")
    p.add_argument("--aot-cache", metavar="DIR", default=None,
                   help="persist serialized PJRT executables under DIR and "
                        "load them on later starts (utils/aot.py).  "
                        "CGX_AOT_CACHE env is equivalent")
    args = p.parse_args(argv)
    if args.aot_cache:
        from cgx_tpu.utils import aot
        aot.enable(args.aot_cache)
    import dataclasses
    cfg = dataclasses.replace(DEFAULT_CONFIG, is_sample=not args.no_sample)
    serve_loop(args.reffile, args.reftargetfile, args.alignfile, args.lexfile,
               cfg, index_dir=args.index_dir, sa_shards=args.sa_shards,
               dp_devices=args.dp_devices,
               prewarm=None if args.no_prewarm else args.prewarm,
               prewarm_queries=args.prewarm_queries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
