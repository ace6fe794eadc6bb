import jax.numpy as jnp
import numpy as np
import pytest

from cudapathtracer_tpu.models import naive, unidirectional
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera
from cudapathtracer_tpu.scene.materials import Material, builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.obj import MeshData


def pixel_grid(w, h):
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    return px.ravel(), py.ravel()


def render(fn, scene, cam, spp, seed=103033, **kw):
    px, py = pixel_grid(cam.width, cam.height)
    key = rng.base_key(seed)
    acc = np.zeros((px.shape[0], 3), np.float32)
    for s in range(spp):
        li, _ = fn(scene, cam, key, s, px, py, **kw)
        acc += np.asarray(li)
    return acc / spp


def test_furnace_closed_box():
    """Uniform emissive Lambertian enclosure: cosine-sampled diffuse has
    beta = albedo^k exactly, so naive PT returns the analytic geometric
    series E * sum_k rho^k with zero variance (SURVEY.md §4 furnace test)."""
    rho, e = 0.5, 1.0
    mesh = MeshData()
    builtin.box(mesh, (-1, -1, -1), (1, 1, 1), 1, (e, e, e))
    # flip normals inward: swap winding by mirroring the box -> simpler:
    # rays start inside; backface normals are auto-flipped toward the ray, so
    # an outward-wound box still shades correctly from inside.
    mats = [Material.air(), Material.diffuse((rho, rho, rho))]
    scene, _ = build_scene(mesh, mats)
    cam = Camera.pinhole((0.0, 0.0, 0.0), 8, 8, 0.0, 0.0, 0.0, 90.0)
    depth = 6
    img = render(naive.render_sample, scene, cam, spp=2, max_depth=depth)
    expected = e * sum(rho ** k for k in range(depth))
    np.testing.assert_allclose(img, expected, rtol=2e-3)


@pytest.mark.smoke
def test_reproducible_bitwise():
    """Threefry keying makes renders bit-identical across runs. On the GPU
    this holds for the unidirectional family; the light-tracing splats of
    BDPT/VCM/SPPM are scatter-adds whose float order varies there
    (chip_smoke.py measures both)."""
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    a = render(unidirectional.render_sample, scene, cam, spp=2, max_depth=5)
    b = render(unidirectional.render_sample, scene, cam, spp=2, max_depth=5)
    np.testing.assert_array_equal(a, b)


def test_seed_changes_image():
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    a = render(unidirectional.render_sample, scene, cam, spp=1, max_depth=4)
    b = render(unidirectional.render_sample, scene, cam, spp=1, seed=7,
               max_depth=4)
    assert np.abs(a - b).max() > 0


@pytest.mark.smoke
def test_no_nan_inf_negative():
    """The reference's NaN=magenta/Inf=green/neg=blue sentinels as a real
    assertion (SURVEY.md §4)."""
    scene, _ = build_scene(builtin.cornell_with_spheres(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), 24, 24, 0.0, 0.0, 0.0, 60.0)
    img = render(unidirectional.render_sample, scene, cam, spp=4, max_depth=16)
    assert np.isfinite(img).all()
    assert (img >= 0).all()


def test_naive_vs_nee_mis_agree():
    """Cross-integrator convergence (SURVEY.md §4: config-driven toggles →
    each strategy converges to the same image)."""
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), 24, 24, 0.0, 0.0, 0.0, 60.0)
    a = render(naive.render_sample, scene, cam, spp=192, max_depth=12)
    b = render(unidirectional.render_sample, scene, cam, spp=48, max_depth=8)
    # compare means; naive's variance on a small area light dominates at this
    # spp (verified unbiased to <1% at 16k spp during development)
    assert abs(a.mean() - b.mean()) / b.mean() < 0.1
    rel_rmse = np.sqrt(np.mean((a - b) ** 2)) / b.mean()
    assert rel_rmse < 0.8


def test_nested_dielectrics_medium_stack():
    """Priority nested media (deviceCode.cu:306-432): a glass sphere
    (priority 1) inside an absorbing water sphere (priority 2). Rays must
    resolve false hits through the lower-priority boundary, apply
    Beer-Lambert absorption of the dominant medium, and stay finite."""
    from cudapathtracer_tpu.scene.builtin import icosphere
    from cudapathtracer_tpu.scene.materials import Material
    from cudapathtracer_tpu.utils.obj import MeshData

    mesh = builtin.cornell_box(light_emission=(6.0, 6.0, 6.0))
    vw, fw = icosphere(3, 0.30, (0.0, -0.15, 0.0))
    nw = vw - np.asarray([0.0, -0.15, 0.0], np.float32)
    nw /= np.linalg.norm(nw, axis=1, keepdims=True)
    mesh.add(vw, fw, 10, normals=nw, nrm_idx=fw)   # water (priority 2)
    vg, fg = icosphere(3, 0.15, (0.0, -0.15, 0.0))
    ng = vg - np.asarray([0.0, -0.15, 0.0], np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    mesh.add(vg, fg, 5, normals=ng, nrm_idx=fg)    # glass (priority 1)

    mats = builtin_materials()
    # give water visible absorption so the Beer path is exercised
    import dataclasses
    mats[10] = dataclasses.replace(mats[10], absorption=(3.0, 0.02, 0.02))
    scene, _ = build_scene(mesh, mats)
    cam = Camera.pinhole((0.0, 0.0, 1.0), 12, 12, 0.0, 0.0, 0.0, 60.0)
    img = render(unidirectional.render_sample, scene, cam, spp=24,
                 max_depth=12)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img.mean() > 0.01
    # absorption is colored: red channel must be clearly dimmer than green
    # in the sphere region (absorption (3.0,0.02,0.02) kills red); the
    # strong differential keeps this robust to RNG realization changes
    center = img.reshape(12, 12, 3)[5:8, 4:8]
    assert center[..., 0].mean() < 0.9 * center[..., 1].mean()
