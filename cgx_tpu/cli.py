"""CLI with the same contract as the reference binary (Main.c:29-62):

    python -m cgx_tpu.cli [-l minmatchlen] [-t fingerlen] [-s timefile] \
        <source_corpus> <query_file> <target_corpus> <alignment_file> \
        <lex_file> <out_dir>

Writes one grammar file per query sentence: ``out_dir/grammar.<i>.{s,n}``
(PrintResults.c:437-441).  ``--engine`` selects the device pipeline (default) or
the sequential oracle; both produce byte-identical grammars.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from cgx_tpu.config import DEFAULT_CONFIG


def _shards_arg(v: str):
    """--sa-shards value: an int shard count, or 'auto' (device-budget
    sizing, utils.budget.resolve_shards)."""
    return v if v == "auto" else int(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cgx_tpu", description=__doc__)
    p.add_argument("-l", dest="minmatchlen", type=int, default=1)
    p.add_argument("-t", dest="fingerlen", type=int, default=10)
    p.add_argument("-s", dest="timefile", default=None)
    p.add_argument("--engine", choices=["device", "oracle"], default="device")
    p.add_argument("--index-dir", default=None,
                   help="persisted corpus-index dir (built on first use)")
    p.add_argument("--build-index-only", action="store_true",
                   help="build + persist the corpus index (requires "
                        "--index-dir) and exit without running queries; the "
                        "query-file argument is ignored")
    p.add_argument("--no-sample", action="store_true",
                   help="disable occurrence sampling (grammar.<i>.n outputs)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the run into DIR")
    p.add_argument("--sa-shards", type=_shards_arg, default=0, metavar="N",
                   help="sharded-index mode: split every O(corpus) device "
                        "array across N devices (corpora beyond one chip's "
                        "HBM); 'auto' sizes the index against the device "
                        "budget and picks the smallest count that fits "
                        "(0 shards = replicated when it fits)")
    p.add_argument("--dp-devices", type=int, default=0, metavar="N",
                   help="local query data parallelism: replicate the index "
                        "on N local devices and fan every device stage's "
                        "work items across them from this one process "
                        "(byte-identical output; for indexes that fit one "
                        "device's HBM)")
    p.add_argument("--query-batches", type=int, default=0, metavar="B",
                   help="pipeline overlap: split queries into B batches and "
                        "run batch i's host scoring concurrently with batch "
                        "i+1's device search/extraction")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address "
                        "(process 0 hosts it); shards the query file across "
                        "processes")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's id (0-based)")
    p.add_argument("reffile")
    p.add_argument("qryfile")
    p.add_argument("reftargetfile")
    p.add_argument("alignfile")
    p.add_argument("lexfile")
    p.add_argument("dest_dir")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (1 <= args.fingerlen <= 10):
        print("finger length must be between 1 and 10", file=sys.stderr)
        return 1
    if args.minmatchlen != 1:
        # In the reference -l only sizes preallocated buffers (ComTypes.h:39-40);
        # it never changes which rules are extracted.  Exact-sized arrays make it
        # moot here, so output is identical for any value — say so out loud.
        print(f"warning: -l {args.minmatchlen} accepted for CLI parity but has "
              "no effect on output (buffer-sizing-only flag in the reference)",
              file=sys.stderr)
    import os
    checked = ("reffile", "reftargetfile", "alignfile", "lexfile") \
        if args.build_index_only else \
        ("reffile", "qryfile", "reftargetfile", "alignfile", "lexfile")
    for name in checked:
        path = getattr(args, name)
        if not os.path.exists(path):
            print(f'Can not open {name} "{path}"', file=sys.stderr)
            return 1
    if args.build_index_only and not args.index_dir:
        print("--build-index-only requires --index-dir", file=sys.stderr)
        return 1
    if args.sa_shards and args.dp_devices:
        print("--sa-shards and --dp-devices are mutually exclusive layouts "
              "(sharded index vs replicated-per-device index)",
              file=sys.stderr)
        return 1
    if args.coordinator is not None and args.sa_shards == "auto":
        print("--sa-shards auto is single-process only; multi-host composed "
              "mode needs an explicit shard count", file=sys.stderr)
        return 1
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, minmatchlen=args.minmatchlen, fingerlen=args.fingerlen,
        is_sample=not args.no_sample)
    t0 = time.perf_counter()
    if args.profile:
        import jax
        jax.profiler.start_trace(args.profile)
    res = None
    if args.build_index_only:
        from cgx_tpu.pipeline import build_artifact
        from cgx_tpu.preproc import corpus as cp
        with open(args.reffile, encoding="utf-8") as fh:
            f_text = fh.read()
        with open(args.reftargetfile, encoding="utf-8") as fh:
            e_text = fh.read()
        _, _, t, _, _ = build_artifact(
            f_text, e_text, cp.read_lines(args.alignfile),
            cp.read_tokens(args.lexfile), cfg, index_dir=args.index_dir,
            sa_shards=args.sa_shards)
        print(f"index built at {args.index_dir}: {t.report()}",
              file=sys.stderr)
    elif args.coordinator is not None:
        from cgx_tpu.parallel import multihost
        from cgx_tpu.preproc import corpus as cp
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)
        with open(args.reffile, encoding="utf-8") as fh:
            f_text = fh.read()
        with open(args.reftargetfile, encoding="utf-8") as fh:
            e_text = fh.read()
        lo, hi, res, total = multihost.run_multihost(
            f_text, e_text, cp.read_lines(args.alignfile),
            cp.read_tokens(args.lexfile), cp.read_lines(args.qryfile),
            args.dest_dir, cfg, index_dir=args.index_dir,
            sa_shards=args.sa_shards, dp_devices=args.dp_devices)
        print(f"multihost: process {args.process_id}: queries [{lo}, {hi}) "
              f"done; {total} grammar lines globally", file=sys.stderr)
    elif args.engine == "oracle":
        from cgx_tpu.oracle.pipeline import run_oracle_files
        run_oracle_files(args.reffile, args.qryfile, args.reftargetfile,
                         args.alignfile, args.lexfile, args.dest_dir, cfg)
    else:
        from cgx_tpu.pipeline import run_pipeline_files
        from cgx_tpu.utils.budget import BudgetError
        try:
            res = run_pipeline_files(args.reffile, args.qryfile,
                                     args.reftargetfile, args.alignfile,
                                     args.lexfile, args.dest_dir, cfg,
                                     index_dir=args.index_dir,
                                     sa_shards=args.sa_shards,
                                     query_batches=args.query_batches,
                                     dp_devices=args.dp_devices)
        except BudgetError as exc:
            # the actionable one-liner, not a JAX allocation traceback
            print(f"error: {exc}", file=sys.stderr)
            return 1
    if args.profile:
        import jax
        jax.profiler.stop_trace()
    wall = time.perf_counter() - t0
    print(f"total: {wall:.3f}s", file=sys.stderr)
    if args.timefile:
        # recordTime analog (Start.cu:392-469): one appended line per run with
        # the phase buckets.  Multi-host runs also append the per-phase MAX
        # across ALL processes (the critical path), so the timefile reflects
        # the whole job, not just this process's local run.
        with open(args.timefile, "a", encoding="utf-8") as fh:
            if res is not None:
                line = f"wall: {wall:.6f}s , {res.timing.report()}"
                gmax = getattr(res.timing, "global_phase_max", None)
                if gmax:
                    line += " | global max-across-processes: " + " , ".join(
                        f"{k}: {v:.3f}s" for k, v in gmax.items())
                fh.write(line + "\n")
            else:
                fh.write(f"wall: {wall:.6f}s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
