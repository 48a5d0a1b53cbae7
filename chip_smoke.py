"""Smoke test of the grammar extractor on NVIDIA GPUs.

    python chip_smoke.py             # one card: phases a-e below
    python chip_smoke.py --cards 4   # four cards: the multi-device layouts only

Drives the system through the entry points a user calls (``cgx_tpu.cli``,
``pipeline.run_pipeline``, ``cgx_tpu.serve``) in this one process — a JAX
process reserves most of a card's memory, so a second one could not share it —
and compares every output byte for byte:

  a. gate: JAX's default device is a GPU and the native preprocessing
     library loads (otherwise the suffix array would silently be built by the
     NumPy fallback);
  b. CLI: the device engine against ``--engine oracle`` (the sequential NumPy
     reference) on the toy and real-text fixtures, sampled and
     ``--no-sample``: identical grammar files;
  c. scale: the ``europarl`` bench corpus (1M sentences, ~7.5M source tokens,
     20k vocabulary, 64 queries), index built in-process into a fresh
     directory, one warm-up run, one timed run; the grammar hash must equal
     the CPU golden in tests/golden_bench_hashes.json;
  d. serve: three requests to ``serve_loop`` on phase b's real-text index,
     each answer identical to the one-shot CLI run;
  e. the tests marked ``gpu`` (tests/test_gpu.py), on this card.

``--cards 4`` runs phase c's data three ways — replicated on one card,
``dp_devices=4`` and ``sa_shards=4`` — and requires the golden hash of each.

The last line of stdout is ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

WORK = os.path.join(ROOT, ".smoke")
SCALE = "europarl"


class SmokeError(RuntimeError):
    """A phase's output disagreed with its reference."""


def log(msg: str):
    print(f"chip_smoke: {msg}", flush=True)


def fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def dir_digest(path: str) -> str:
    """sha256 over the sorted file names and contents of a grammar dir."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        h.update(name.encode() + b"\0")
        with open(os.path.join(path, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def fixtures() -> dict:
    """The toy and real-text fixtures, generated from their seeds on first
    use (tests/fixtures is not committed)."""
    from tools import make_fixture, make_realfixture
    base = os.path.join(ROOT, "tests", "fixtures")
    out = {}
    for name, build in (("toy", make_fixture.build),
                        ("real", make_realfixture.build)):
        d = os.path.join(base, name)
        if not os.path.exists(os.path.join(d, "query.f")):
            build(d)
        out[name] = d
    return out


def _cli_args(fixture: str, out: str, extra=()):
    return list(extra) + [os.path.join(fixture, n) for n in (
        "corpus.f", "query.f", "corpus.e", "corpus.a", "lex.txt")] + [out]


def phase_cli(fx: dict, work: str) -> dict:
    """b. cli.main with the device engine and with the oracle, sampled and
    not; returns {tag: device grammar dir}.  Each fixture's device runs share
    one index dir under ``work`` (the first builds it, the second loads)."""
    from cgx_tpu import cli
    dirs = {}
    for name, fixture in fx.items():
        index_dir = os.path.join(work, f"index_{name}")
        for extra in ((), ("--no-sample",)):
            tag = name + ("-nosample" if extra else "")
            dev = os.path.join(work, "cli", tag, "device")
            orc = os.path.join(work, "cli", tag, "oracle")
            t0 = time.perf_counter()
            rc = cli.main(_cli_args(fixture, dev, ("--engine", "device",
                                                   "--index-dir", index_dir)
                                    + extra))
            t_dev = time.perf_counter() - t0
            if rc != 0:
                raise SmokeError(f"cli {tag}: device engine exited {rc}")
            t0 = time.perf_counter()
            rc = cli.main(_cli_args(fixture, orc, ("--engine", "oracle")
                                    + extra))
            t_orc = time.perf_counter() - t0
            if rc != 0:
                raise SmokeError(f"cli {tag}: oracle exited {rc}")
            d_dev, d_orc = dir_digest(dev), dir_digest(orc)
            n = len(os.listdir(dev))
            if not n or d_dev != d_orc:
                raise SmokeError(f"cli {tag}: device grammars {d_dev[:16]} "
                                 f"differ from the oracle's {d_orc[:16]}")
            log(f"b. cli {tag}: {n} grammar files byte-identical to the "
                f"oracle, sha256 {d_dev[:16]} (device {t_dev:.3f}s, "
                f"oracle {t_orc:.3f}s)")
            dirs[tag] = dev
    return dirs


def load_scale(size: str):
    """(pipeline inputs, golden grammar hash) of a bench size."""
    import bench
    n_sent, n_q = bench.SIZES[size]
    t0 = time.perf_counter()
    data = bench.build_corpus(size, n_sent, n_q)
    with open(bench.GOLDEN) as fh:
        golden = json.load(fh)[f"bench_{size}"]
    log(f"{size}: {n_sent} sentences, {n_q} queries generated in "
        f"{time.perf_counter() - t0:.3f}s")
    return data, golden


def run_scale(data, golden: str, index_dir: str, label: str, **layout):
    """One run_pipeline; raises unless its grammar hash is the golden one.
    Returns (result, wall seconds)."""
    import bench
    from cgx_tpu import pipeline as tpl
    from cgx_tpu.config import DEFAULT_CONFIG
    t0 = time.perf_counter()
    res = tpl.run_pipeline(*data, DEFAULT_CONFIG, index_dir=index_dir,
                           **layout)
    wall = time.perf_counter() - t0
    h = bench.grammar_hash(res.per_query_lines)
    log(f"{label}: wall {wall:.3f}s, {res.counters['total_lines']} grammar "
        f"lines, hash {h[:16]}")
    log(f"{label}: {res.timing.report()}")
    if h != golden:
        raise SmokeError(f"{label}: grammar hash {h[:16]} != golden "
                         f"{golden[:16]}")
    return res, wall


def phase_scale(size: str, work: str) -> str:
    """c. build the index into a fresh dir, warm up, time one run."""
    import bench
    data, golden = load_scale(size)
    index_dir = fresh_dir(os.path.join(work, f"index_{size}"))
    warm, t_warm = run_scale(data, golden, index_dir, f"c. {size} warm-up")
    one_time = sum(warm.timing.buckets.get(k, 0.0)
                   for k in bench.ONE_TIME_PHASES)
    res, t_run = run_scale(data, golden, index_dir, f"c. {size} timed")
    log(f"c. {size}: warm-up {t_warm:.3f}s = index build {one_time:.3f}s "
        f"+ query path {t_warm - one_time:.3f}s with compilation; timed "
        f"run {t_run:.3f}s")
    log(f"c. {size}: grammar hash equals golden bench_{size}")
    return golden


def phase_serve(fixture: str, one_shot: str, work: str) -> int:
    """d. three requests to serve_loop on the fixture's index (built in
    phase b), each answer byte-identical to the one-shot run."""
    from cgx_tpu import serve
    index_dir = os.path.join(work, "index_real")
    dests = [os.path.join(work, "serve", str(i)) for i in range(3)]
    query = os.path.join(fixture, "query.f")
    inp = io.StringIO("".join(f"{query} {d}\n" for d in dests))
    out = io.StringIO()
    served = serve.serve_loop(*(os.path.join(fixture, n) for n in (
        "corpus.f", "corpus.e", "corpus.a", "lex.txt")),
        index_dir=index_dir, inp=inp, out=out)
    replies = out.getvalue().splitlines()
    for r in replies:
        log(f"d. serve: {r}")
    if served != 3 or not replies[0].startswith("ready ") \
            or not all(r.startswith("ok ") for r in replies[1:]):
        raise SmokeError(f"serve answered {replies!r}")
    want = dir_digest(one_shot)
    for d in dests:
        if dir_digest(d) != want:
            raise SmokeError(f"serve answer in {d} differs from the one-shot "
                             f"run")
    log(f"d. serve: 3 answers byte-identical to the one-shot run "
        f"({want[:16]})")
    return served


def load_test_module(name: str):
    """A module of tests/ by its path (another installed package may own the
    name ``tests``)."""
    import importlib.util
    path = os.path.join(ROOT, "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"cgx_tests_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_gpu_tests(device):
    """e. every test in tests/test_gpu.py, called with this card."""
    test_gpu = load_test_module("test_gpu")
    names = sorted(n for n in dir(test_gpu) if n.startswith("test_"))
    for name in names:
        t0 = time.perf_counter()
        getattr(test_gpu, name)(device)
        log(f"e. {name}: passed ({time.perf_counter() - t0:.3f}s)")
    return len(names)


def phase_four_cards(size: str, work: str):
    """Phase c's data replicated on one card, then fanned over four cards
    (dp_devices) and split across them (sa_shards); all must hash golden."""
    data, golden = load_scale(size)
    index_dir = fresh_dir(os.path.join(work, f"index_{size}"))
    for label, layout in (("replicated on 1 card", {}),
                          ("dp_devices=4", {"dp_devices": 4}),
                          ("sa_shards=4", {"sa_shards": 4})):
        run_scale(data, golden, index_dir, f"{size} {label}", **layout)
    log(f"{size}: replicated, dp_devices=4 and sa_shards=4 all equal golden "
        f"bench_{size}")


def peak_bytes(device) -> str:
    stats = device.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "n/a"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the replicated / dp_devices=4 / "
                         "sa_shards=4 comparison on four cards")
    args = ap.parse_args(argv)

    import jax
    import bench
    log(f"jax {jax.__version__}")
    devs = bench.require_gpu(args.cards)
    from cgx_tpu.preproc.native_build import load_native
    if load_native() is None:
        raise SmokeError("the native preprocessing library did not build or "
                         "load")
    log(f"a. {len(devs)} x {devs[0].device_kind}; native library loaded")
    print(bench.card_description(), flush=True)

    work = fresh_dir(WORK)
    try:
        if args.cards == 4:
            phase_four_cards(SCALE, work)
            for d in devs[:4]:
                log(f"peak_bytes_in_use {d.id}: {peak_bytes(d)}")
        else:
            fx = fixtures()
            one_shot = phase_cli(fx, work)
            phase_scale(SCALE, work)
            log(f"c. peak_bytes_in_use: {peak_bytes(devs[0])}")
            phase_serve(fx["real"], one_shot["real"], work)
            phase_gpu_tests(devs[0])
            log(f"peak_bytes_in_use: {peak_bytes(devs[0])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
