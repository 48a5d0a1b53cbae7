"""chip_smoke.py and bench.py on the CPU: both refuse to run without a GPU,
and the smoke test's phase functions, called on the toy fixture, give the
hashes the CPU tests hold (the oracle's bytes and the golden bench hash)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))


@pytest.mark.parametrize("cmd", [["chip_smoke.py"],
                                 ["bench.py", "--size", "toy"]])
def test_refuses_a_cpu_only_backend(cmd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable] + cmd, cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a GPU" in r.stderr


def test_phases_on_toy_fixture(toy_fixture, real_fixture, tmp_path):
    import chip_smoke as cs
    fx = {"toy": str(toy_fixture), "real": str(real_fixture)}
    one_shot = cs.phase_cli(fx, str(tmp_path))
    assert set(one_shot) == {"toy", "toy-nosample", "real", "real-nosample"}
    import bench
    import json
    golden = json.loads(pathlib.Path(bench.GOLDEN).read_text())
    assert cs.phase_scale("toy", str(tmp_path)) == golden["bench_toy"]
    assert cs.phase_serve(fx["real"], one_shot["real"], str(tmp_path)) == 3
