"""Fixed-seed golden renders: one per integrator family.

16x16 Cornell-with-blocks frames at 8 spp, stored in tests/golden/*.npy and
compared by RMSE (the framework's version of the reference's
saveImageCSV_MONO numeric-diff workflow, imageUtil.cu:123). The same
definitions drive the tests (tests/test_golden.py), the regeneration tool
(tools/gen_goldens.py) and the check on the GPU (chip_smoke.py).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from cudapathtracer_tpu.models import (bdpt, unidirectional,
                                       unidirectional_mega, vcm)
from cudapathtracer_tpu.utils.compile_cache import CHECKOUT
from cudapathtracer_tpu.utils.image import rmse

GOLDEN_DIR = os.path.join(CHECKOUT, "tests", "golden")
SIZE, SPP = 16, 8
# Threefry keying is bit-stable, but XLA reassociation differs slightly
# across processes, flag sets and backends (measured up to ~3e-4 rmse on
# a ~0.7-mean image on XLA:CPU). Any real estimator change moves pixels
# by >>1e-2 at 8 spp, so 1e-3 separates noise from drift.
RMSE_MAX = 1e-3

_SPPM = vcm.VCMConfig(eye_depth=6, light_depth=4, light_trace=False,
                      nee=False, naive=False, connection=False,
                      do_mis=False, do_sppm=True)


def family(name: str, width: int = 128):
    """(golden file, jitted per-sample fn, its static kwargs) for one
    family: fn(scene, cam, key, s, px, py, **kw) -> (li, rays). `width` is
    the mega engine's lane count; its image does not depend on it."""
    if name == "uni":
        return ("cornell_uni_16x16_8spp.npy", unidirectional.render_sample,
                {"max_depth": 6})
    if name == "mega":
        return ("cornell_mega_16x16_8spp.npy",
                unidirectional_mega.render_sample,
                {"max_depth": 6, "width": width})
    if name == "bdpt":
        return ("cornell_bdpt_16x16_8spp.npy", bdpt.render_sample,
                {"cfg": bdpt.BDPTConfig(eye_depth=6, light_depth=4)})
    if name == "vcm":
        return ("cornell_vcm_16x16_8spp.npy", vcm.render_sample,
                {"cfg": vcm.VCMConfig(eye_depth=6, light_depth=4)})
    if name == "sppm":
        return "cornell_sppm_16x16_8spp.npy", vcm.render_sample, {"cfg": _SPPM}
    raise ValueError(f"unknown golden family {name!r}")


FAMILIES = ("uni", "mega", "bdpt", "vcm", "sppm")


def setup():
    """(scene, camera, px, py) of the golden frame on the default device."""
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene

    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), SIZE, SIZE, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(SIZE), jnp.arange(SIZE))
    return scene, cam, px.ravel(), py.ravel()


def render(frame, name: str, width: int = 128) -> np.ndarray:
    """Mean radiance [SIZE*SIZE, 3] of SPP samples of family `name`."""
    from cudapathtracer_tpu.utils import rng

    _, fn, kw = family(name, width)
    scene, cam, px, py = frame
    key = rng.base_key()
    acc = np.zeros((SIZE * SIZE, 3), np.float32)
    for s in range(SPP):
        li, _ = fn(scene, cam, key, s, px, py, **kw)
        acc += np.asarray(li)
    return acc / SPP


def compile_family(frame, name: str, width: int = 128):
    """Compile family `name`'s per-sample program ahead of time (render()
    then reuses it)."""
    from cudapathtracer_tpu.utils import rng

    _, fn, kw = family(name, width)
    scene, cam, px, py = frame
    return fn.lower(scene, cam, rng.base_key(), 0, px, py, **kw).compile()


def golden_rmse(frame, name: str, width: int = 128) -> float:
    """RMSE of a fresh render of family `name` against its stored golden."""
    fname = family(name, width)[0]
    return rmse(render(frame, name, width),
                np.load(os.path.join(GOLDEN_DIR, fname)))
