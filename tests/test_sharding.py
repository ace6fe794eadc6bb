import jax
import numpy as np
import pytest

from cudapathtracer_tpu.models import naive, unidirectional
from cudapathtracer_tpu.parallel import sharding
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera
from cudapathtracer_tpu.scene.materials import builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene


@pytest.fixture(scope="module")
def setup():
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), 16, 16, 0.0, 0.0, 0.0, 60.0)
    return scene, cam


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.smoke
def test_tile_sharded_render(setup):
    scene, cam = setup
    mesh = sharding.make_mesh(n_tile=8, n_spp=1)
    acc, done, rays = sharding.render_sharded(
        unidirectional.render_sample, mesh, scene, cam, 16, 16, 2,
        max_depth=4)
    assert done == 2 and rays > 0
    assert np.isfinite(acc).all()
    assert acc.mean() > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_spp_mesh_psum(setup):
    """2-D mesh: 4 tile shards x 2 spp shards, radiance psum over spp."""
    scene, cam = setup
    mesh = sharding.make_mesh(n_tile=4, n_spp=2)
    acc, done, rays = sharding.render_sharded(
        naive.render_sample, mesh, scene, cam, 16, 16, 4, max_depth=4)
    assert done == 4
    assert np.isfinite(acc).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_matches_single_device_brightness(setup):
    """Sharded and unsharded renders use different (per-chip) RNG streams but
    must agree in expectation."""
    scene, cam = setup
    mesh = sharding.make_mesh(n_tile=8, n_spp=1)
    spp = 48
    acc_s, done, _ = sharding.render_sharded(
        naive.render_sample, mesh, scene, cam, 16, 16, spp, max_depth=4)
    from cudapathtracer_tpu.utils import rng
    import jax.numpy as jnp
    px, py = jnp.meshgrid(jnp.arange(16), jnp.arange(16))
    key = rng.base_key()
    acc_u = np.zeros_like(acc_s)
    for s in range(spp):
        li, _ = naive.render_sample(scene, cam, key, s, px.ravel(), py.ravel(),
                                    max_depth=4)
        acc_u += np.asarray(li)
    m_s, m_u = acc_s.mean() / done, acc_u.mean() / spp
    assert abs(m_s - m_u) / m_u < 0.1


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    li, rays = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(li)).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.smoke
def test_graft_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_spp_sharded_bdpt(setup):
    """Splat-based integrators shard correctly over the spp axis (each chip
    renders the full image; radiance psum across devices)."""
    from functools import partial

    from cudapathtracer_tpu.models import bdpt
    scene, cam = setup
    cfg = bdpt.BDPTConfig(eye_depth=4, light_depth=3)
    fn = partial(bdpt.render_sample, cfg=cfg)
    mesh = sharding.make_mesh(n_tile=1, n_spp=8)
    acc, done, rays = sharding.render_sharded(fn, mesh, scene, cam, 16, 16, 8)
    assert done == 8 and rays > 0
    assert np.isfinite(acc).all()
    assert acc.mean() > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_sharded_bdpt_splat_matches_single_device(setup):
    """Tile-sharded BDPT (full-image splat + psum over the tile axis,
    splat=True) must reproduce the single-device render: RNG streams are
    pixel-id keyed, so each shard generates exactly its pixels' light
    paths and the psum-ed splat equals the single-chip scatter-add up to
    float summation order."""
    import jax.numpy as jnp

    from cudapathtracer_tpu.models import bdpt
    from cudapathtracer_tpu.utils import rng

    scene, cam = setup
    cfg = bdpt.BDPTConfig(eye_depth=4, light_depth=3)
    mesh = sharding.make_mesh(n_tile=8, n_spp=1)
    acc_s, done, rays_s = sharding.render_sharded(
        bdpt.render_sample, mesh, scene, cam, 16, 16, 1, splat=True, cfg=cfg)
    assert done == 1 and rays_s > 0

    px, py = jnp.meshgrid(jnp.arange(16), jnp.arange(16))
    key = rng.base_key()
    li, rays_u = bdpt.render_sample(scene, cam, key, 0, px.ravel(),
                                    py.ravel(), cfg=cfg)
    acc_u = np.asarray(li)
    assert int(rays_s) == int(rays_u)
    np.testing.assert_allclose(acc_s, acc_u, rtol=2e-4, atol=2e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_sharded_vcm_splat_finite(setup):
    """VCM light-trace splat under tile x spp sharding: runs, finite,
    non-black (merge off keeps the photon grid out of this test)."""
    from cudapathtracer_tpu.models import vcm

    scene, cam = setup
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=3, do_merge=False)
    mesh = sharding.make_mesh(n_tile=4, n_spp=2)
    acc, done, rays = sharding.render_sharded(
        vcm.render_sample, mesh, scene, cam, 16, 16, 2, splat=True, cfg=cfg)
    assert done == 2 and rays > 0
    assert np.isfinite(acc).all()
    assert acc.mean() > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_sharded_vcm_merge(setup):
    """FULL VCM (merge ON) under tile sharding must reproduce the
    single-chip render: photons are all-gathered over the tile axis
    (photon_axis), the grid is built per shard on the union, and
    eta_vcm / merge normalization use the global path count. Tolerance is
    float-summation order only (the gathered photon rows concatenate
    shard-major instead of depth-major, so within-cell fold order
    differs); max_per_cell is large enough that the cap never binds and
    the candidate SET is identical."""
    import jax.numpy as jnp

    from cudapathtracer_tpu.models import vcm
    from cudapathtracer_tpu.utils import rng

    scene, cam = setup
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=3, do_merge=True,
                        max_per_cell=64, r0_multiplier=0.05)
    mesh = sharding.make_mesh(n_tile=8, n_spp=1)
    acc_s, done, rays_s = sharding.render_sharded(
        vcm.render_sample, mesh, scene, cam, 16, 16, 1, splat=True,
        cfg=cfg, photon_axis="tile")
    assert done == 1 and rays_s > 0

    px, py = jnp.meshgrid(jnp.arange(16), jnp.arange(16))
    key = rng.base_key()
    li, rays_u = vcm.render_sample(scene, cam, key, 0, px.ravel(),
                                   py.ravel(), cfg=cfg)
    acc_u = np.asarray(li)
    assert int(rays_s) == int(rays_u)
    np.testing.assert_allclose(acc_s, acc_u, rtol=2e-4, atol=2e-5)
    assert acc_u.mean() > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_shard_ray_counts_balance(setup):
    """Multi-chip scaling evidence (BASELINE config 5 correctness side):
    the same frame on an 8-device tile mesh does the same total work as
    single-chip, spread evenly — per-device traced-ray counts stay within
    2x of each other on the Cornell frame (contiguous pixel rows of a
    mostly-covered view), so no chip serializes the render."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cudapathtracer_tpu.utils import rng

    scene, cam = setup
    mesh = sharding.make_mesh(n_tile=8, n_spp=1)
    px, py = jnp.meshgrid(jnp.arange(16), jnp.arange(16))
    px, py = px.ravel(), py.ravel()
    key = rng.base_key()

    def per_shard(scene_r, cam_r, pxs, pys):
        li, rays = unidirectional.render_sample(scene_r, cam_r, key, 0,
                                                pxs, pys, max_depth=4)
        return li, rays[None]

    li_s, rays_per = jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(sharding.replicated_specs(scene),
                  sharding.replicated_specs(cam), P("tile"), P("tile")),
        out_specs=(P("tile"), P("tile")), check_vma=False,
    ))(scene, cam, px, py)
    counts = np.asarray(rays_per)
    assert counts.shape == (8,) and (counts > 0).all()
    assert counts.max() / counts.min() < 2.0
    # total work matches the single-chip render exactly (same RNG streams)
    _, rays_u = unidirectional.render_sample(scene, cam, key, 0, px, py,
                                             max_depth=4)
    assert int(counts.sum()) == int(rays_u)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_tile_sharded_mega_engine(setup):
    """The persistent mega-wavefront engine (the production headline path)
    runs under the tile x spp mesh: each shard drives its own lane machine
    over its pixel block. Its RNG ids are local to the pixel slice, so the
    sharded image is a different (equally valid) noise realization than
    single-chip — assert finiteness + brightness agreement, not equality."""
    from cudapathtracer_tpu.models import unidirectional_mega

    scene, cam = setup
    mesh = sharding.make_mesh(n_tile=4, n_spp=2)
    acc, done, rays = sharding.render_sharded(
        unidirectional_mega.render_sample, mesh, scene, cam, 16, 16, 2,
        max_depth=4)
    assert done == 2 and rays > 0
    assert np.isfinite(acc).all()
    acc1, _, _ = sharding.render_sharded(
        unidirectional.render_sample, mesh, scene, cam, 16, 16, 2,
        max_depth=4)
    # same estimator, different stream: means agree within MC noise
    assert abs(acc.mean() - acc1.mean()) / max(acc1.mean(), 1e-6) < 0.25
