"""REAL multi-host execution: two actual OS processes coordinated through
``jax.distributed`` (CPU backend), sharing one persisted index artifact, each
writing its contiguous query shard's grammar files — byte-compared against a
single-process run (SURVEY.md section 2.3 comm-backend row)."""

import os
import pathlib
import shutil
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bootstrap_timeout(outs) -> bool:
    """True iff a failure looks like the jax.distributed coordinator
    bootstrap timing out under CPU contention (the only retryable failure —
    a deterministic crash must surface, not be masked by a retry)."""
    markers = (b"DEADLINE_EXCEEDED", b"timed out", b"Timed out",
               b"barrier_timeout", b"coordination service")
    return any(any(m in se for m in markers) for _, se in outs)


def _run_two(cmd_for_pid, out_dirs, attempts=2):
    """Launch the 2-process run; retry ONLY on coordinator-bootstrap timeout,
    with output/state dirs cleared between attempts."""
    for attempt in range(attempts):
        procs = [subprocess.Popen(cmd_for_pid(pid), cwd=str(REPO),
                                  env=cmd_for_pid.env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for pid in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        if all(p.returncode == 0 for p in procs):
            return procs, outs
        if attempt + 1 < attempts and _bootstrap_timeout(outs):
            for d in out_dirs:
                shutil.rmtree(d, ignore_errors=True)
            cmd_for_pid.port = _free_port()
            continue
        break
    return procs, outs


@pytest.mark.slow
def test_two_processes_sharded_index_composed(toy_fixture, tmp_path):
    """Multi-host x sharded-index composition (VERDICT r2 missing #2): the
    index shards span BOTH processes' devices (2 processes x 1 CPU device,
    --sa-shards 2 over the global mesh), each process dispatches only its
    local shard's work and rows exchange via sum-allgather; grammars must be
    byte-identical to a single-process replicated run."""
    port = _free_port()
    out_mh = str(tmp_path / "out_mh_shard")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("JAX_NUM_PROCESSES", None)
    f = str(toy_fixture)
    args = [f + "/corpus.f", f + "/query.f", f + "/corpus.e",
            f + "/corpus.a", f + "/lex.txt"]

    def cmd_for_pid(pid):
        return [sys.executable, "-m", "cgx_tpu.cli",
                "--coordinator", f"127.0.0.1:{cmd_for_pid.port}",
                "--num-processes", "2", "--process-id", str(pid),
                "--sa-shards", "2"] + args + [out_mh]
    cmd_for_pid.port = port
    cmd_for_pid.env = env
    procs, outs = _run_two(cmd_for_pid, [out_mh])
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    out_ref = str(tmp_path / "out_ref_shard")
    cmd = [sys.executable, "-m", "cgx_tpu.cli"] + args + [out_ref]
    r = subprocess.run(cmd, cwd=str(REPO), env=env, capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]

    ref_files = sorted(os.listdir(out_ref))
    mh_files = sorted(os.listdir(out_mh))
    assert ref_files == mh_files and len(ref_files) > 0
    for name in ref_files:
        with open(os.path.join(out_ref, name), "rb") as fh:
            a = fh.read()
        with open(os.path.join(out_mh, name), "rb") as fh:
            b = fh.read()
        assert a == b, f"grammar file {name} differs between the composed "\
            "multihost+sharded run and the single-process run"


@pytest.mark.slow
def test_two_processes_localdp_composed(toy_fixture, tmp_path):
    """Multi-host x local-DP composition (VERDICT r4 missing #2): 2 processes
    x 2 local devices each (--dp-devices 2), the natural one-process-per-host
    slice deployment — queries shard across processes while each process fans
    its device stages over its OWN local pair via LocalDPEngine; grammars must
    be byte-identical to a single-process single-device run."""
    port = _free_port()
    idx_dir = str(tmp_path / "index_dp")
    out_mh = str(tmp_path / "out_mh_dp")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_NUM_PROCESSES", None)
    f = str(toy_fixture)
    args = [f + "/corpus.f", f + "/query.f", f + "/corpus.e",
            f + "/corpus.a", f + "/lex.txt"]

    def cmd_for_pid(pid):
        return [sys.executable, "-m", "cgx_tpu.cli",
                "--coordinator", f"127.0.0.1:{cmd_for_pid.port}",
                "--num-processes", "2", "--process-id", str(pid),
                "--dp-devices", "2", "--index-dir", idx_dir] + args + [out_mh]
    cmd_for_pid.port = port
    cmd_for_pid.env = env
    procs, outs = _run_two(cmd_for_pid, [out_mh, idx_dir])
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    out_ref = str(tmp_path / "out_ref_dp")
    env1 = dict(env)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    cmd = [sys.executable, "-m", "cgx_tpu.cli"] + args + [out_ref]
    r = subprocess.run(cmd, cwd=str(REPO), env=env1, capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]

    ref_files = sorted(os.listdir(out_ref))
    mh_files = sorted(os.listdir(out_mh))
    assert ref_files == mh_files and len(ref_files) > 0
    for name in ref_files:
        with open(os.path.join(out_ref, name), "rb") as fh:
            a = fh.read()
        with open(os.path.join(out_mh, name), "rb") as fh:
            b = fh.read()
        assert a == b, f"grammar file {name} differs between the composed "\
            "multihost+localdp run and the single-process run"


@pytest.mark.slow
def test_two_real_processes_byte_identical(toy_fixture, tmp_path):
    port = _free_port()
    idx_dir = str(tmp_path / "index")
    out_mh = str(tmp_path / "out_mh")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env.pop("JAX_NUM_PROCESSES", None)
    f = str(toy_fixture)
    args = [f + "/corpus.f", f + "/query.f", f + "/corpus.e",
            f + "/corpus.a", f + "/lex.txt"]

    # distributed bootstrap can time out under full-suite CPU contention
    # (2 workers + pytest on few cores): retry once, on that failure only
    def cmd_for_pid(pid):
        return [sys.executable, "-m", "cgx_tpu.cli",
                "--coordinator", f"127.0.0.1:{cmd_for_pid.port}",
                "--num-processes", "2", "--process-id", str(pid),
                "--index-dir", idx_dir] + args + [out_mh]
    cmd_for_pid.port = port
    cmd_for_pid.env = env
    procs, outs = _run_two(cmd_for_pid, [out_mh, idx_dir])
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    # single-process reference (same artifact directory: load path exercised)
    out_ref = str(tmp_path / "out_ref")
    cmd = [sys.executable, "-m", "cgx_tpu.cli", "--index-dir", idx_dir] + \
        args + [out_ref]
    r = subprocess.run(cmd, cwd=str(REPO), env=env, capture_output=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]

    ref_files = sorted(os.listdir(out_ref))
    mh_files = sorted(os.listdir(out_mh))
    assert ref_files == mh_files and len(ref_files) > 0
    for name in ref_files:
        with open(os.path.join(out_ref, name), "rb") as fh:
            a = fh.read()
        with open(os.path.join(out_mh, name), "rb") as fh:
            b = fh.read()
        assert a == b, f"grammar file {name} differs between multihost and "\
            "single-process runs"
