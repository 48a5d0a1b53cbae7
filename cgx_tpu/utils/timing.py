"""Phase wall-clock + device-memory ledger, the analog of timing_t
(ComTypes.h:80-91), recordTime (Start.cu:392-469) and the reference's pervasive
cudaMemGetInfo tracing (SuffixArray.cu:776-777, Start.cu:471-486): same bucket
concept, surfaced as a dict + report, with per-phase device-memory marks."""

from __future__ import annotations

import contextlib
import os
import sys
import time


class StageMarks:
    """Env-gated (``CGX_STAGE_DEBUG=1``) intra-stage wall-clock marks for
    performance work; zero-cost when disabled."""

    __slots__ = ("enabled", "tag", "last", "parts")

    def __init__(self, tag: str):
        self.enabled = bool(os.environ.get("CGX_STAGE_DEBUG"))
        self.tag = tag
        self.last = time.perf_counter() if self.enabled else 0.0
        self.parts = []

    def mark(self, name: str):
        if self.enabled:
            now = time.perf_counter()
            self.parts.append((name, now - self.last))
            self.last = now

    def done(self):
        if self.enabled and self.parts:
            print(f"[{self.tag}] " + " ".join(
                f"{n}:{d:.3f}s" for n, d in self.parts), file=sys.stderr)


def device_memory_bytes() -> int:
    """Bytes the default device's allocator has in use; -1 on the CPU
    backend, which keeps no device memory statistics."""
    import jax
    stats = jax.local_devices()[0].memory_stats()
    return int(stats["bytes_in_use"]) if stats else -1


class PhaseTimer:
    """``phase(name)`` accumulates wall time per bucket and records the HBM
    ``bytes_in_use`` after each phase (the reference logged free memory around
    every kernel; here it is one ledger surfaced with the timings)."""

    def __init__(self, track_memory: bool = True):
        self.buckets: dict = {}
        self.mem_after: dict = {}
        self.track_memory = track_memory

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.buckets[name] = self.buckets.get(name, 0.0) + (
                time.perf_counter() - t0)
            if self.track_memory:
                m = device_memory_bytes()
                if m >= 0:
                    self.mem_after[name] = m

    def peak_memory(self) -> int:
        return max(self.mem_after.values(), default=-1)

    def report(self) -> str:
        total = sum(self.buckets.values())
        parts = [f"total: {total:.3f}s"]
        parts += [f"{k}: {v:.3f}s" for k, v in self.buckets.items()]
        if self.mem_after:
            peak = self.peak_memory()
            parts.append(f"hbm_peak: {peak / 1e6:.1f}MB")
        return " , ".join(parts)

    def memory_report(self) -> str:
        if not self.mem_after:
            return "hbm: n/a (backend exposes no memory stats)"
        return " , ".join(f"{k}: {v / 1e6:.1f}MB"
                          for k, v in self.mem_after.items())

    def as_dict(self) -> dict:
        return dict(self.buckets)
