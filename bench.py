"""Benchmark driver: end-to-end gappy grammar extraction throughput.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...",
   "rules_per_s": N, "sa_lookups_per_s": N, "warmup_s": N,
   "hbm_peak_mb": N, "conformance": "ok"|"untracked"}

Everything else goes to stderr.  Without ``--cpu`` the run needs a GPU: it
exits non-zero when JAX's default device is anything else, since JAX without
its CUDA plugin silently runs on the CPU and a CPU time is not a device time.

Conformance on hardware: after the measured reps the produced grammar lines are
hashed and compared against ``tests/golden_bench_hashes.json`` (golden hashes
computed once on the CPU backend, byte-identical to the sequential oracle by
the conformance test suite) — the chip numbers are only reported over output
proven correct on the chip itself.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SIZES = {
    "toy": (300, 8),
    "small": (2000, 16),
    "medium": (20000, 32),
    "large": (100000, 64),
    "europarl": (1000000, 64),   # Europarl-scale: ~7.5M source tokens, 20k vocab
    # adversarial realism: non-monotone alignments (reversed windows), 1:N
    # fan-out, N:1 lending, ~30% unaligned — the consistency kill paths fire
    "hard": (100000, 64),
    # whole-test-set batches (the reference's allqueries.txt use case)
    "medium512": (20000, 512),
    "large512": (100000, 512),
    # natural French-English text with IBM-Model-1 alignments
    # (tools/make_realfixture.py; VERDICT r3 #7)
    "real": (150, 24),
}

GOLDEN = os.path.join(ROOT, "tests", "golden_bench_hashes.json")


def require_gpu(n_devices: int = 1):
    """JAX's devices, or exit non-zero unless the default device is a GPU
    and at least ``n_devices`` are visible."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"{sys.argv[0]}: JAX's default device is "
                 f"{devs[0].platform!r}, not a GPU")
    if len(devs) < n_devices:
        sys.exit(f"{sys.argv[0]}: {n_devices} GPUs needed, {len(devs)} found")
    return devs


def card_description() -> str:
    """Name and power limit of each card, one line per card, as nvidia-smi
    reports them (a card set below its maximum power runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def build_corpus(size: str, n_sentences: int, n_queries: int,
                 seed: int = 20260817):
    sys.path.insert(0, __file__.rsplit("/", 1)[0] + "/tools")
    if size == "real":
        root = os.path.dirname(os.path.abspath(__file__))
        d = os.path.join(root, "tests", "fixtures", "real")
        if not os.path.exists(os.path.join(d, "corpus.f")):
            from tools.make_realfixture import build
            build(d)
        def rl(name):
            with open(os.path.join(d, name), encoding="utf-8") as fh:
                return [ln for ln in fh.read().split("\n") if ln]
        return (rl("corpus.f"), rl("corpus.e"), rl("corpus.a"),
                " ".join(rl("lex.txt")).split(), rl("query.f"))
    if size == "europarl":
        from tools.make_bigcorpus import make_big_corpus, make_big_queries
        f_text, e_text, a_lines, lex_tokens = make_big_corpus(
            n_sentences, vocab=20000, seed=seed)
        q_lines = make_big_queries(f_text, n_queries)
        return f_text, e_text, a_lines, lex_tokens, q_lines
    if size == "hard":
        from tools.make_bigcorpus import make_hard_corpus, make_big_queries
        f_text, e_text, a_lines, lex_tokens = make_hard_corpus(
            n_sentences, vocab=20000)
        q_lines = make_big_queries(f_text, n_queries)
        return f_text, e_text, a_lines, lex_tokens, q_lines
    from tools import make_fixture as mf

    rng = random.Random(seed)
    f_lines, e_lines, a_lines = mf.make_parallel_corpus(rng, n_sentences)
    lex_lines = mf.make_lex_file(rng, f_lines, e_lines, a_lines)
    q_lines = mf.make_queries(rng, f_lines, n_queries)
    return f_lines, e_lines, a_lines, " ".join(lex_lines).split(), q_lines


def grammar_hash(per_query_lines) -> str:
    h = hashlib.sha256()
    for lines in per_query_lines:
        for ln in lines:
            h.update(ln.encode())
            h.update(b"\n")
        h.update(b"\x00")
    return h.hexdigest()


ONE_TIME_PHASES = ("suffixarray", "precompute", "refsin", "qrysin",
                   "indexload", "indexsave")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=list(SIZES), default="small")
    ap.add_argument("--reps", type=int, default=5,
                    help="measured repetitions; best query-path time wins")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--sa-shards", type=int, default=0,
                    help="run the query path on the fully-sharded index "
                         "engine over this many devices (with --cpu, set "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                         "for a virtual mesh)")
    ap.add_argument("--query-batches", type=int, default=0,
                    help="run the pipeline-overlap mode with B query batches")
    ap.add_argument("--dp-devices", type=int, default=0,
                    help="single-process local query-DP: replicate the index "
                         "per device and fan the work items over N local "
                         "devices (with --cpu, set XLA_FLAGS=--xla_force_"
                         "host_platform_device_count=N for a virtual mesh)")
    ap.add_argument("--index-dir", default=None,
                    help="persist/load the corpus index (amortizes the "
                         "one-time build across reps; default: a per-size "
                         "cache dir under .bench_index/ for large sizes)")
    ap.add_argument("--update-golden", action="store_true",
                    help="write this run's grammar hash to the golden file "
                         "(use on the CPU backend only)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu(max(args.sa_shards, args.dp_devices, 1))
        print(f"bench: card: {card_description()}", file=sys.stderr)

    from cgx_tpu.config import DEFAULT_CONFIG
    from cgx_tpu import pipeline as tpl

    n_sent, n_q = SIZES[args.size]
    print(f"bench: generating {n_sent}-sentence corpus, {n_q} queries",
          file=sys.stderr)
    t0 = time.perf_counter()
    data = build_corpus(args.size, n_sent, n_q)
    print(f"bench: corpus ready in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    cfg = DEFAULT_CONFIG

    index_dir = args.index_dir
    if index_dir is None and args.size in ("large", "europarl", "hard",
                                           "large512"):
        # large512 shares large's corpus (same generator seed) => same index
        key = "large" if args.size == "large512" else args.size
        index_dir = os.path.join(ROOT, ".bench_index", key)

    def run_once():
        if args.query_batches > 1:
            return tpl.run_pipeline_overlap(*data, cfg, index_dir=index_dir,
                                            query_batches=args.query_batches,
                                            sa_shards=args.sa_shards,
                                            dp_devices=args.dp_devices)
        return tpl.run_pipeline(*data, cfg, index_dir=index_dir,
                                sa_shards=args.sa_shards,
                                dp_devices=args.dp_devices)

    warmup_s = -1.0
    if not args.no_warmup:
        print("bench: warmup run (compile)", file=sys.stderr)
        t0 = time.perf_counter()
        run_once()
        warmup_s = time.perf_counter() - t0
        print(f"bench: warmup {warmup_s:.1f}s", file=sys.stderr)

    best = None
    for rep in range(args.reps):
        t0 = time.perf_counter()
        r = run_once()
        w = time.perf_counter() - t0
        b = r.timing.as_dict()
        ot = sum(b.get(k, 0) for k in ONE_TIME_PHASES)
        qt = w - ot
        print(f"bench: rep {rep}: wall {w:.2f}s query-path {qt:.2f}s",
              file=sys.stderr)
        if best is None or qt < best[2]:
            best = (r, w, qt, ot)
    res, wall, query_time, one_time = best
    qps = n_q / query_time if query_time > 0 else 0.0
    rules_ps = res.counters["total_lines"] / query_time if query_time > 0 else 0.0
    c = res.counters
    sa_lookups = (c.get("pass1_tokens", 0) + c.get("pass2_items", 0)
                  + c.get("onegap_sa", 0) + c.get("twogap_sa", 0))
    sa_ps = sa_lookups / query_time if query_time > 0 else 0.0
    hbm_peak = res.timing.peak_memory()
    print(f"bench: wall {wall:.2f}s (one-time index {one_time:.2f}s, "
          f"query path {query_time:.2f}s)", file=sys.stderr)
    print("bench:", res.timing.report(), file=sys.stderr)
    print("bench hbm:", res.timing.memory_report(), file=sys.stderr)
    print("bench counters:", res.counters, file=sys.stderr)
    print(f"bench: {qps:.3f} query-sentences/s, {rules_ps:.0f} grammar "
          f"lines/s, {sa_ps:.0f} SA-lookups/s", file=sys.stderr)

    # on-hardware conformance: hash the grammars this (chip) run produced
    ghash = grammar_hash(res.per_query_lines)
    golden = {}
    if os.path.exists(GOLDEN):
        with open(GOLDEN) as fh:
            golden = json.load(fh)
    key = f"bench_{args.size}"
    if args.update_golden:
        golden[key] = ghash
        with open(GOLDEN, "w") as fh:
            json.dump(golden, fh, indent=1, sort_keys=True)
        print(f"bench: golden hash for {key} updated", file=sys.stderr)
    if key in golden:
        if golden[key] != ghash:
            print(f"bench: CONFORMANCE FAILURE: grammar hash {ghash[:16]} != "
                  f"golden {golden[key][:16]}", file=sys.stderr)
            sys.exit(1)
        conformance = "ok"
        print("bench: conformance ok (grammar hash matches golden)",
              file=sys.stderr)
    else:
        conformance = "untracked"
        print(f"bench: no golden hash for {key} (hash {ghash[:16]})",
              file=sys.stderr)

    tag = f"_sharded{args.sa_shards}" if args.sa_shards else ""
    if args.dp_devices:
        tag += f"_dp{args.dp_devices}"
    print(json.dumps({
        "metric": f"query_sentences_per_s_{args.size}{tag}",
        "value": round(qps, 4),
        "unit": "qry/s",
        "rules_per_s": round(rules_ps, 1),
        "sa_lookups_per_s": round(sa_ps, 1),
        "warmup_s": round(warmup_s, 1),
        "hbm_peak_mb": round(hbm_peak / 1e6, 1) if hbm_peak > 0 else -1,
        "conformance": conformance,
    }))


if __name__ == "__main__":
    main()
