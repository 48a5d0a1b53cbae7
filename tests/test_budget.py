"""Device-memory budgeting (utils.budget): the index is sized against the
device BEFORE placement — auto-shard selection, or a one-line actionable
error instead of a JAX OOM (reference analog: the 2000 MB budget at
Start.cu:496 and suffixArrayGetEquivalentMaxRefLen, SuffixArray.c:244-260).

The budget is mocked via the CGX_DEVICE_MEM_MB override."""

import pathlib

import numpy as np
import pytest

from cgx_tpu.utils import budget as bd


@pytest.fixture
def mock_budget(monkeypatch):
    def set_mb(mb):
        monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(mb))
    return set_mb


def test_footprint_matches_real_index(toy_fixture):
    """The computed footprint equals the bytes of the arrays build_index
    actually places (bucket padding included)."""
    from cgx_tpu.config import DEFAULT_CONFIG as cfg
    from cgx_tpu.preproc import corpus as cp
    from cgx_tpu.preproc import suffix_array as sab
    from cgx_tpu.index import container as ic
    F = toy_fixture
    src = cp.load_source_corpus(cp.read_lines(str(F / "corpus.f")))
    tgt = cp.load_target_corpus(cp.read_lines(str(F / "corpus.e")))
    al = cp.load_alignment(cp.read_lines(str(F / "corpus.a")), src, tgt)
    lex = cp.load_lex_table(cp.read_tokens(str(F / "lex.txt")),
                            src.vocab, tgt.vocab)
    sa = sab.build_index(src.str_)
    ix = ic.build_index(src, tgt, sa, al, lex, cfg)
    placed = sum(np.asarray(a).nbytes for a in (
        ix.refstr_padded, ix.sa, ix.lcpleft, ix.lcpright, ix.rlp,
        ix.l_tar, ix.r_tar, ix.lr_tar, ix.tgt_str))
    est = bd.replicated_footprint_bytes(src.toklen, tgt.toklen,
                                        cfg.qry_max_length,
                                        cfg.max_rule_span)
    assert est == placed


def test_resolve_fits_replicated(mock_budget):
    mock_budget(1000)           # 1 GB: a 100k-token corpus trivially fits
    assert bd.resolve_shards(0, 100_000, 100_000) == 0
    assert bd.resolve_shards("auto", 100_000, 100_000) == 0
    assert bd.resolve_shards(4, 100_000, 100_000) == 4   # explicit honored


def test_resolve_raises_one_liner_when_too_big(mock_budget):
    mock_budget(2)              # 2 MB: nothing fits
    with pytest.raises(bd.BudgetError, match="--sa-shards"):
        bd.resolve_shards(0, 10_000_000, 10_000_000)
    # explicit-but-too-few also diagnosed
    with pytest.raises(bd.BudgetError, match="or more"):
        bd.resolve_shards(2, 100_000_000, 100_000_000)


def test_resolve_auto_picks_smallest_fit(mock_budget):
    src = tgt = 10_000_000
    need = bd.replicated_footprint_bytes(src, tgt)
    # budget such that the index needs ~3 shards
    mb = need / 3 / bd.REF_INDEX_RATIO / 1024**2 * 1.05
    mock_budget(mb)
    s = bd.resolve_shards("auto", src, tgt)
    assert 2 <= s <= 8
    usable = bd.device_budget_bytes() * bd.REF_INDEX_RATIO
    assert need / s <= usable          # the pick fits
    assert s == 2 or need / (s - 1) > usable   # and is minimal


def test_no_budget_means_no_check(monkeypatch):
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    # CPU backend exposes no budget: explicit requests pass through
    assert bd.resolve_shards(0, 10**9, 10**9) == 0
    assert bd.resolve_shards("auto", 10**9, 10**9) == 0


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budget_reads_bytes_limit_of_a_gpu(monkeypatch):
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    dev = _FakeDevice({"bytes_limit": 60 * 1024**3, "bytes_in_use": 0})
    assert bd.device_budget_bytes(dev) == 60 * 1024**3
    assert bd.resolve_shards("auto", 10**8, 10**8, device=dev) == 0
    need = bd.replicated_footprint_bytes(4 * 10**9, 4 * 10**9)
    assert bd.resolve_shards("auto", 4 * 10**9, 4 * 10**9, device=dev) \
        == -(-need // int(60 * 1024**3 * bd.REF_INDEX_RATIO)) > 1


@pytest.mark.parametrize("stats", [None, {"bytes_in_use": 0}])
def test_budget_raises_for_a_gpu_without_stats(monkeypatch, stats):
    """No assumed size: an accelerator that reports no bytes_limit is an
    error, not a default."""
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        bd.device_budget_bytes(_FakeDevice(stats))


def test_cli_budget_error_is_one_line(toy_fixture, tmp_path, monkeypatch,
                                      capsys):
    from cgx_tpu import cli
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", "0.05")   # 50 KB: toy can't fit
    F = pathlib.Path(toy_fixture)
    rc = cli.main([str(F / "corpus.f"), str(F / "query.f"),
                   str(F / "corpus.e"), str(F / "corpus.a"),
                   str(F / "lex.txt"), str(tmp_path / "g")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "rerun with --sa-shards" in err


def test_cli_auto_shards_runs_sharded(toy_fixture, tmp_path, monkeypatch):
    """--sa-shards auto under a tiny budget selects a sharded layout and
    still produces byte-identical grammars."""
    from cgx_tpu import cli
    F = pathlib.Path(toy_fixture)
    base = [str(F / "corpus.f"), str(F / "query.f"), str(F / "corpus.e"),
            str(F / "corpus.a"), str(F / "lex.txt")]
    assert cli.main(base + [str(tmp_path / "rep")]) == 0
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", "0.05")
    assert cli.main(["--sa-shards", "auto"] + base
                    + [str(tmp_path / "auto")]) == 0
    a = sorted((tmp_path / "rep").glob("grammar.*"))
    b = sorted((tmp_path / "auto").glob("grammar.*"))
    assert len(a) > 0 and [p.read_bytes() for p in a] == \
        [p.read_bytes() for p in b]
