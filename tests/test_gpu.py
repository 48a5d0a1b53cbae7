"""Tests that need an NVIDIA GPU.

They skip on the CPU.  ``python chip_smoke.py`` runs them on the card (its
phase e), calling each with the device in place of the ``gpu_device``
fixture, so every test here takes that one argument and nothing else."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {d.platform}")
    return d


def test_budget_is_the_cards_bytes_limit(gpu_device):
    """The index budget is what the card's allocator reports, not a table."""
    from cgx_tpu.utils import budget as bd
    limit = gpu_device.memory_stats()["bytes_limit"]
    assert limit > 0
    assert bd.device_budget_bytes(gpu_device) == limit


def test_memory_ledger_reads_the_card(gpu_device):
    """PhaseTimer records the allocator's bytes_in_use after a phase."""
    import jax
    from cgx_tpu.utils.timing import PhaseTimer
    t = PhaseTimer()
    with t.phase("alloc"):
        x = jax.device_put(np.zeros(1 << 20, np.int32), gpu_device)
        x.block_until_ready()
    assert t.mem_after["alloc"] >= x.nbytes
    assert "hbm_peak" in t.report()


def test_maxlex_float_chain_bit_equal_on_card(gpu_device):
    """MaxLex's sequential float32 add chain is the one float path on the
    device: on the card it must stay bit-equal to the host loop (no
    reassociation, no flushed denormals)."""
    import test_units
    test_units.test_maxlex_device_probe_matches_host()
