"""The native BVH library is built from the repository's own sources:
keyed by a hash of csrc/, written atomically, rebuilt when a source
changes, and safe to build from several processes at once."""

import ctypes
import multiprocessing as mp
import os
import shutil

from cudapathtracer_tpu.scene import native

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


def _copy_sources(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_CSRC, src)
    return str(src), str(tmp_path / "build")


def _build(args):
    return native.build_library(*args)


def test_concurrent_builds_share_one_library(tmp_path):
    src, build = _copy_sources(tmp_path)
    ctx = mp.get_context("spawn")
    with ctx.Pool(2) as pool:
        paths = pool.map(_build, [(src, build), (src, build)], chunksize=1)
    assert paths[0] == paths[1] == native.library_path(src, build)
    # only the finished library is left (no temporary files), and it loads
    assert os.listdir(build) == [os.path.basename(paths[0])]
    lib = ctypes.CDLL(paths[0])
    assert hasattr(lib, "tpt_build_bvh") and hasattr(lib, "tpt_bvh8_collapse")


def test_source_change_rebuilds(tmp_path):
    src, build = _copy_sources(tmp_path)
    first = native.build_library(src, build)
    assert native.build_library(src, build) == first  # cached
    with open(os.path.join(src, "bvh_builder.cpp"), "a") as f:
        f.write("\n// touched\n")
    second = native.build_library(src, build)
    assert second != first and os.path.exists(second)
    ctypes.CDLL(second)
