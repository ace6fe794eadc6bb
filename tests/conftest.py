"""Test configuration: force an 8-device virtual CPU mesh BEFORE jax import
so the sharding tests run without accelerators (SURVEY.md §4). Both platform
variables are overridden, not defaulted: the suite always runs on the CPU;
tests that need a GPU are marked `gpu` and skip here (chip_smoke.py covers
them on the card)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
# CPU XLA compile time explodes with the unrolled traversal body; one step
# per while iteration keeps the suite fast (the default is 4)
os.environ.setdefault("TPT_STEPS_PER_ITER", "1")
# Same for the persistent mega-wavefront schedule (default 6 steps in 3
# minis): XLA:CPU compile is super-linear in the unrolled body. The image
# is schedule-invariant, so goldens still match.
os.environ.setdefault("TPT_MEGA_STEPS_PER_ITER", "1")
os.environ.setdefault("TPT_MEGA_MINI_SPLITS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# pytest plugins (xdist/anyio/...) import jax before this conftest runs, and
# jax snapshots JAX_PLATFORMS into its config at import — override it too
import jax  # noqa: E402

from cudapathtracer_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

jax.config.update("jax_platforms", "cpu")
# Persistent XLA compile cache shared by the whole suite, including the
# subprocess-isolated heavy modules (test_heavy_isolated.py), which would
# otherwise recompile everything per subprocess. JAX_COMPILATION_CACHE_DIR
# wins when set; exporting the resolved path lets subprocesses share it.
os.environ["JAX_COMPILATION_CACHE_DIR"] = enable_compile_cache()
# keep the thousands of trivial sub-second executables out of the cache
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# ---------------------------------------------------------------------------
# Heavy-compile isolation: the mega-engine VCM/BDPT modules (and the
# many-config classic VCM module) carry the suite's biggest XLA graphs,
# and XLA:CPU has been observed to flakily segfault inside
# backend_compile late in a long suite run (the same modules pass in
# isolation). They are therefore collected OUT of the
# in-process run and executed in fresh subprocesses by
# tests/test_heavy_isolated.py — one compiler crash can then fail one
# wrapper test (with one retry for signal exits) instead of killing the
# whole pytest process. Run them directly with TPT_HEAVY_DIRECT=1, e.g.
#   TPT_HEAVY_DIRECT=1 python -m pytest tests/test_vcm_mega.py
# The smoke tier (-m smoke) keeps collecting them in-process: its subset
# is small and starts from a fresh process anyway.
# test_sharding.py is in the set too: its 8-device pjit executables are
# the largest in-process compiles, and the flaky crash was seen there once
# (in the cache-write path, compilation_cache.put_executable_and_time).
HEAVY_MODULES = {"test_vcm_mega.py", "test_bdpt_mega.py", "test_vcm.py",
                 "test_sharding.py"}


def pytest_ignore_collect(collection_path, config):
    if os.environ.get("TPT_HEAVY_DIRECT") == "1":
        return None
    if "smoke" in (config.getoption("-m") or ""):
        return None
    if collection_path.name in HEAVY_MODULES:
        return True
    return None
