"""CLI contract tests (in-process, CPU backend)."""

import pathlib

import pytest

from cgx_tpu import cli


def _args(toy_fixture, out, extra=()):
    F = pathlib.Path(toy_fixture)
    return list(extra) + [str(F / "corpus.f"), str(F / "query.f"),
                          str(F / "corpus.e"), str(F / "corpus.a"),
                          str(F / "lex.txt"), str(out)]


def test_cli_tpu_engine_writes_grammars(toy_fixture, tmp_path):
    rc = cli.main(_args(toy_fixture, tmp_path / "g", ["--engine", "device"]))
    assert rc == 0
    files = sorted((tmp_path / "g").glob("grammar.*.s"))
    assert len(files) == 8
    first = files[0].read_text().splitlines()
    assert first and first[0].startswith("[X] ||| ")


def test_cli_rejects_bad_fingerlen(toy_fixture, tmp_path, capsys):
    rc = cli.main(_args(toy_fixture, tmp_path / "g", ["-t", "0"]))
    assert rc == 1


def test_cli_rejects_missing_file(tmp_path):
    rc = cli.main(["/nonexistent.f", "/nonexistent.q", "/nonexistent.e",
                   "/nonexistent.a", "/nonexistent.l", str(tmp_path / "g")])
    assert rc == 1


def test_build_index_only_then_query_reuses_artifact(toy_fixture, tmp_path):
    """--build-index-only persists a loadable artifact; a later query run
    loads it (indexload phase) and produces the same grammars as a fresh
    build."""
    import os
    F = pathlib.Path(toy_fixture)
    idx = tmp_path / "idx"
    rc = cli.main(["--build-index-only", "--index-dir", str(idx),
                   str(F / "corpus.f"), "IGNORED_QUERY_FILE",
                   str(F / "corpus.e"), str(F / "corpus.a"),
                   str(F / "lex.txt"), str(tmp_path / "unused")])
    assert rc == 0
    assert os.path.exists(idx / "meta.json")
    rc = cli.main(_args(toy_fixture, tmp_path / "g1",
                        ["--index-dir", str(idx)]))
    assert rc == 0
    rc = cli.main(_args(toy_fixture, tmp_path / "g2"))
    assert rc == 0
    a = sorted((tmp_path / "g1").glob("grammar.*"))
    b = sorted((tmp_path / "g2").glob("grammar.*"))
    assert [p.read_bytes() for p in a] == [p.read_bytes() for p in b]


def test_build_index_only_requires_index_dir(toy_fixture, tmp_path):
    F = pathlib.Path(toy_fixture)
    rc = cli.main(["--build-index-only",
                   str(F / "corpus.f"), "q", str(F / "corpus.e"),
                   str(F / "corpus.a"), str(F / "lex.txt"),
                   str(tmp_path / "g")])
    assert rc == 1


@pytest.mark.parametrize("use_prewarm", [None, "file", "auto"])
def test_serve_loop_byte_identical_across_requests(toy_fixture, tmp_path,
                                                   use_prewarm):
    """The long-lived serve loop answers several query batches from ONE
    engine context, each byte-identical to a one-shot CLI run — with the
    prewarm batch disabled, from a file, and synthesized from the corpus
    (the production default)."""
    import io
    from cgx_tpu import serve

    F = pathlib.Path(toy_fixture)
    # two different query batches: the full file and its first 3 lines
    q_all = F / "query.f"
    q_small = tmp_path / "q_small.f"
    q_small.write_text("\n".join(
        q_all.read_text().splitlines()[:3]) + "\n")

    req = io.StringIO(f"{q_all} {tmp_path / 's_all'}\n"
                      f"{q_small} {tmp_path / 's_small'}\n"
                      f"{q_all} {tmp_path / 's_again'}\n")
    out = io.StringIO()
    served = serve.serve_loop(str(F / "corpus.f"), str(F / "corpus.e"),
                              str(F / "corpus.a"), str(F / "lex.txt"),
                              inp=req, out=out,
                              prewarm={"file": str(q_small), "auto": "auto",
                                       None: None}[use_prewarm])
    assert served == 3
    replies = out.getvalue().splitlines()
    assert replies[0].startswith("ready ")
    assert all(r.startswith("ok ") for r in replies[1:])

    rc = cli.main(_args(toy_fixture, tmp_path / "one_shot"))
    assert rc == 0
    ref = sorted((tmp_path / "one_shot").glob("grammar.*"))
    for served_dir in ("s_all", "s_again"):
        got = sorted((tmp_path / served_dir).glob("grammar.*"))
        assert [p.read_bytes() for p in got] == [p.read_bytes() for p in ref]
    # the small batch: queries 0-2 of the full run, renumbered identically
    by_q = lambda p: int(p.name.split(".")[1])  # noqa: E731
    small = sorted((tmp_path / "s_small").glob("grammar.*"), key=by_q)
    full = sorted((tmp_path / "one_shot").glob("grammar.*"), key=by_q)
    assert [p.read_bytes() for p in small] == [p.read_bytes()
                                               for p in full[:3]]
