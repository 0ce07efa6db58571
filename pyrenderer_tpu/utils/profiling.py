"""Profiling & observability (SURVEY §5.1).

The reference's profiling was wall-clock samples/s prints
(main_taichi.py:114) and out-of-band line_profiler runs (commented @profile
hooks, bvh.py:217). Here:

- `DeviceTimer`: wall-clock spans that end in `jax.block_until_ready`, so
  they time the device work and not just its enqueue;
- `RenderStats`: rays/s and samples/s accounting fed by the integrator's
  own in-scan ray counters (with_stats=True);
- `trace_profile`: context manager around jax.profiler for xprof dumps;
- `gpu_card()`: the card's name and power limit as nvidia-smi reports them,
  to print beside every device number (a card set below its maximum power
  runs slower under load).
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Optional

import jax


class DeviceTimer:
    """with DeviceTimer() as t: out = f(...); t.payload = out -> t.seconds.

    Both boundaries wait with jax.block_until_ready: on entry for work
    already queued, on exit for `payload` (set it to the timed call's
    result), so the span covers the device work and not just its enqueue.
    """

    def __init__(self, payload=None):
        self.payload = payload
        self.seconds = 0.0

    def __enter__(self):
        jax.block_until_ready(self.payload)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        jax.block_until_ready(self.payload)
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclasses.dataclass
class RenderStats:
    rays: float = 0.0
    samples: int = 0
    pixels: int = 0
    seconds: float = 0.0

    def add(self, rays: float, samples: int, pixels: int, seconds: float):
        self.rays += rays
        self.samples += samples
        self.pixels = pixels
        self.seconds += seconds

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-12) / 1e6

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.seconds, 1e-12)

    def summary(self) -> str:
        return (
            f"{self.mrays_per_sec:.1f} Mrays/s, "
            f"{self.samples_per_sec:.2f} samples/s, "
            f"{self.samples} spp over {self.pixels} px in {self.seconds:.2f}s"
        )


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]):
    """jax.profiler trace if a directory is given (view with xprof/TB).
    A profiler failure propagates: a run asked to trace must not return
    without its trace."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def gpu_card() -> str:
    """First line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
