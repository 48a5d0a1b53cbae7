"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding logic is
testable without accelerators (SURVEY.md section 4 implication (c))."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import subprocess
import sys

import jax
import pytest

# Pin the tests to the virtual CPU mesh even where JAX_PLATFORMS names another
# platform: the config setting takes precedence over the environment.
jax.config.update("jax_platforms", "cpu")

FIXTURE_DIR = pathlib.Path(__file__).parent / "fixtures" / "toy"
REAL_FIXTURE_DIR = pathlib.Path(__file__).parent / "fixtures" / "real"


@pytest.fixture(scope="session")
def toy_fixture():
    if not (FIXTURE_DIR / "corpus.f").exists():
        subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).parent.parent / "tools" / "make_fixture.py")],
            check=True,
        )
    return FIXTURE_DIR


@pytest.fixture(scope="session")
def real_fixture():
    """Natural French-English parallel text with IBM-Model-1 alignments
    (tools/make_realfixture.py) — checked in; regenerable byte-stable."""
    if not (REAL_FIXTURE_DIR / "corpus.f").exists():
        subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).parent.parent / "tools" / "make_realfixture.py")],
            check=True,
        )
    return REAL_FIXTURE_DIR
