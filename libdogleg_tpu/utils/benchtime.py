"""Device timing: a host clock around `jax.block_until_ready`.

JAX dispatches asynchronously, so a call returns before the device has
finished; `block_until_ready` waits for every output buffer, which makes
the host clock around it a measurement of the work. The first call
compiles and is reported apart from the warm calls. A card may be set
below its maximum power and then runs slower under load, so every time
is reported beside the card's name and power limit (`card_line`).
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Timing:
    first_s: float     # first call: tracing and compilation included
    warm_s: float      # median of the warm calls
    runs_s: tuple      # every warm call
    out: Any           # the last call's output


def measure(fn: Callable, *args, reps: int = 5) -> Timing:
    """Time fn(*args): one first call, one untimed warm-up, then `reps`
    timed warm calls, each ended by block_until_ready. Pass a jitted fn:
    an eager one is timed op by op."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return Timing(first, statistics.median(runs), tuple(runs), out)


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), read in a child process that
    does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def power_limit_w(line: str) -> float:
    """The power limit in watts from a card_line()."""
    return float(line.rsplit(",", 1)[1].strip().split()[0])
