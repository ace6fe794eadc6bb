"""Sample batching (models/batch.py): k samples in one dispatch must be
bit-identical to k single dispatches summed — the positional-Threefry RNG
guarantee that makes the batched fori_loop a pure scheduling choice (the
analogue of batching the reference's CUDA-Graph replays,
main.cu:538-599)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudapathtracer_tpu.models import unidirectional, unidirectional_mega
from cudapathtracer_tpu.models.batch import make_batched
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera
from cudapathtracer_tpu.scene.materials import builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene
from cudapathtracer_tpu.utils import rng

SIZE = 12


@pytest.fixture(scope="module")
def setup():
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), SIZE, SIZE, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(SIZE), jnp.arange(SIZE))
    return scene, cam, px.ravel(), py.ravel()


def _assert_batch_matches_singles(setup, inner, k=3, s0=2):
    scene, cam, px, py = setup
    key = rng.base_key()
    acc = np.zeros((SIZE * SIZE, 3), np.float32)
    rtot = 0
    for s in range(s0, s0 + k):
        li, rays = inner(scene, cam, key, s, px, py)
        acc += np.asarray(li)
        rtot += int(rays)
    bli, brays = make_batched(inner)(scene, cam, key, s0, px, py, k)
    np.testing.assert_array_equal(np.asarray(bli), acc)
    assert int(brays) == rtot


def test_batch_classic_bit_identical(setup):
    _assert_batch_matches_singles(
        setup, lambda sc, c, kk, s, px, py: unidirectional.render_sample(
            sc, c, kk, s, px, py, max_depth=4))


def test_batch_mega_bit_identical(setup):
    _assert_batch_matches_singles(
        setup, lambda sc, c, kk, s, px, py: unidirectional_mega.render_sample(
            sc, c, kk, s, px, py, max_depth=4, grid_w=SIZE))


def test_driver_samples_per_dispatch_invariant(tmp_path):
    """The driver renders the same accumulation whether it dispatches
    sample-by-sample or in batches (including a remainder batch)."""
    from cudapathtracer_tpu.driver import Renderer
    from cudapathtracer_tpu.utils.config import RenderConfig, MeshConfig

    def cfg(spd):
        return RenderConfig(
            width=SIZE, height=SIZE, integrator="UNIDIRECTIONAL",
            engine="classic", sample_count=5, max_depth=4,
            meshes=[MeshConfig(path="builtin:cornell_blocks")],
            samples_per_dispatch=spd, output_dir=str(tmp_path))

    img1 = Renderer(cfg(1)).render(progressive=False, verbose=False)
    img2 = Renderer(cfg(2)).render(progressive=False, verbose=False)
    np.testing.assert_array_equal(img1.pixels, img2.pixels)


def test_auto_samples_per_dispatch():
    """Auto (0): accelerator small frames batch, CPU and large frames
    stay per-sample; explicit values always win."""
    from cudapathtracer_tpu.driver import resolve_samples_per_dispatch
    from cudapathtracer_tpu.utils.config import RenderConfig

    small = RenderConfig(width=256, height=256)
    large = RenderConfig(width=1920, height=1080)
    assert resolve_samples_per_dispatch(small, backend="gpu") == 8
    assert resolve_samples_per_dispatch(
        RenderConfig(width=512, height=512), backend="gpu") == 8
    assert resolve_samples_per_dispatch(large, backend="gpu") == 1
    assert resolve_samples_per_dispatch(small, backend="cpu") == 1
    assert resolve_samples_per_dispatch(
        RenderConfig(width=256, height=256, samples_per_dispatch=3),
        backend="cpu") == 3
