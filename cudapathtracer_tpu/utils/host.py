"""The machine a run measures on: the GPU's name and power limit, and how
many threads compile programs ahead of time (chip_smoke.py, bench.py,
tools/nightly_rmse.py)."""

from __future__ import annotations

import os
import subprocess

# XLA compiles one program per thread; half the host's cores leaves the
# other half to the thread that renders meanwhile.
COMPILE_WORKERS = max(2, (os.cpu_count() or 4) // 2)


def card_info() -> str:
    """`name, power limit` of the first card, from nvidia-smi in a child
    process (it stays off JAX, so it holds no device memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
