"""Persistent mega-VCM (models/vcm_mega.py) vs the classic scan VCM.

The mega machine is a different (equally valid) noise realization of the
same estimator, so agreement is statistical; schedule invariance is exact
(the image is a pure function of the pixel-keyed RNG streams)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudapathtracer_tpu.models import vcm, vcm_mega
from cudapathtracer_tpu.scene import builtin
from cudapathtracer_tpu.scene.camera import Camera
from cudapathtracer_tpu.scene.materials import builtin_materials
from cudapathtracer_tpu.scene.scene import build_scene
from cudapathtracer_tpu.utils import rng

W = 12


@pytest.fixture(scope="module")
def setup():
    mesh = builtin.cornell_box(light_scale=1.6,
                               light_emission=(3.0, 3.0, 3.0))
    builtin.box(mesh, (-0.30, -0.5, -0.25), (-0.05, 0.1, 0.0), 2)
    builtin.box(mesh, (0.05, -0.5, 0.05), (0.30, -0.2, 0.30), 2)
    scene, _ = build_scene(mesh, builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), W, W, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(W), jnp.arange(W))
    return scene, cam, px.ravel(), py.ravel()


def rend(setup, fn, spp, **kw):
    scene, cam, px, py = setup
    key = rng.base_key()
    acc = np.zeros((W * W, 3), np.float32)
    for s in range(spp):
        li, _ = fn(scene, cam, key, s, px, py, **kw)
        acc += np.asarray(li)
    return acc / spp


def test_vcm_mega_agrees_with_classic_vcm(setup):
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4, max_per_cell=8)
    m = rend(setup, vcm_mega.render_sample, 32, cfg=cfg)
    c = rend(setup, vcm.render_sample, 32, cfg=cfg)
    assert np.isfinite(m).all() and (m >= 0).all()
    assert abs(m.mean() - c.mean()) / c.mean() < 0.12
    # pixelwise correlation, not just the mean
    rel = np.abs(m.mean(-1) - c.mean(-1)) / (c.mean(-1) + 0.05)
    assert np.median(rel) < 0.35


def test_vcm_mega_merge_batch_matches_fold(setup, monkeypatch):
    """The batched-slot merge (TPT_MEGA_MERGE_BATCH=1, default) is the
    sequential fold with a different summation order: same candidates,
    same MIS math — images agree to ~ulps and the drop counter exactly."""
    import jax
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4, max_per_cell=4)
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("TPT_MEGA_MERGE_BATCH", flag)
        jax.clear_caches()  # the flag is read at trace time
        li, _rays, drop = vcm_mega.render_sample(
            scene, cam, key, 3, px, py, cfg=cfg, steps_per_iter=2,
            mini_splits=1, count_merge_dropped=True)
        outs[flag] = (np.asarray(li), int(drop))
    assert outs["1"][1] == outs["0"][1]
    np.testing.assert_allclose(outs["1"][0], outs["0"][0], rtol=1e-4,
                               atol=1e-6)


def test_vcm_mega_merge_compactq_matches_slots(setup, monkeypatch):
    """The per-query compacted candidate stream (TPT_MEGA_MERGE_CAPQ) at a
    cap covering every candidate (8 cells x cap) must reproduce the
    default batched-slot merge: same candidates, same drop counter,
    images equal to summation-order ulps."""
    import jax
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4, max_per_cell=4)
    outs = {}
    for capq in ("32", "0"):
        monkeypatch.setenv("TPT_MEGA_MERGE_CAPQ", capq)
        jax.clear_caches()  # read at trace time
        li, _rays, drop = vcm_mega.render_sample(
            scene, cam, key, 3, px, py, cfg=cfg, steps_per_iter=2,
            mini_splits=1, count_merge_dropped=True)
        outs[capq] = (np.asarray(li), int(drop))
    monkeypatch.delenv("TPT_MEGA_MERGE_CAPQ", raising=False)
    jax.clear_caches()
    assert outs["32"][1] == outs["0"][1]
    np.testing.assert_allclose(outs["32"][0], outs["0"][0], rtol=1e-4,
                               atol=1e-6)


def test_vcm_mega_window_retire_bit_identical(setup, monkeypatch):
    """retire="window" (unidirectional_mega.RETIRE, read at trace time)
    writes the same slots/values as the full [K,W] sweep — bit-identical
    image, same ray count."""
    import jax

    from cudapathtracer_tpu.models import unidirectional_mega as um
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4, max_per_cell=4)
    kw = dict(steps_per_iter=2, mini_splits=1, width=24)
    a, ra = vcm_mega.render_sample(scene, cam, key, 3, px, py, cfg=cfg,
                                   **kw)
    monkeypatch.setattr(um, "RETIRE", "window")
    jax.clear_caches()
    b, rb = vcm_mega.render_sample(scene, cam, key, 3, px, py, cfg=cfg,
                                   **kw)
    monkeypatch.undo()
    jax.clear_caches()
    assert int(ra) == int(rb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_vcm_mega_schedule_invariant(setup):
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=3, max_per_cell=8)
    a, _ = vcm_mega.render_sample(scene, cam, key, 0, px, py, cfg=cfg,
                                  steps_per_iter=2, mini_splits=1)
    b, _ = vcm_mega.render_sample(scene, cam, key, 0, px, py, cfg=cfg,
                                  steps_per_iter=3, mini_splits=1)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def test_vcm_mega_width_and_chunk_invariant(setup):
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=3, max_per_cell=8)
    a, _ = vcm_mega.render_sample(scene, cam, key, 1, px, py, cfg=cfg,
                                  width=W * W)
    b, _ = vcm_mega.render_sample(scene, cam, key, 1, px, py, cfg=cfg,
                                  width=48)
    # different wavefront widths change light-path chunking only when the
    # chunk changes; same chunk => identical image
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def test_vcm_mega_merge_capacity_invariant(setup):
    """The compacted deferred merge is a pure scheduling change: any
    sub-wavefront capacity must reproduce the legacy full-width fold
    (deferred lanes re-shade bit-identically from counter-keyed RNG)."""
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=3, max_per_cell=8)
    kw = dict(cfg=cfg, width=W * W)
    legacy, _ = vcm_mega.render_sample(scene, cam, key, 2, px, py,
                                       merge_w=W * W, **kw)
    ample, _ = vcm_mega.render_sample(scene, cam, key, 2, px, py,
                                      merge_w=64, **kw)
    tiny, _ = vcm_mega.render_sample(scene, cam, key, 2, px, py,
                                     merge_w=8, **kw)
    np.testing.assert_allclose(np.asarray(ample), np.asarray(legacy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tiny), np.asarray(legacy),
                               rtol=1e-5, atol=1e-6)


def test_sppm_mega_mode_runs(setup):
    cfg = vcm.VCMConfig(eye_depth=5, light_depth=4, light_trace=False,
                        nee=False, naive=False, connection=False,
                        do_mis=False, do_merge=True, do_sppm=True,
                        max_per_cell=16, r0_multiplier=0.05)
    v = rend(setup, vcm_mega.render_sample, 16, cfg=cfg)
    assert np.isfinite(v).all()
    assert v.mean() > 0.02


def test_vcm_mega_reports_merge_dropped(setup):
    """Driver-facing merge-cap counter on the PRODUCTION engine (the classic
    path counts; the default mega path must too). A tiny cap with a fat radius
    must fire on the Cornell scene; counting must not change the image or ray
    tally."""
    scene, cam, px, py = setup
    key = rng.base_key()
    cfg = vcm.VCMConfig(eye_depth=4, light_depth=4, max_per_cell=1,
                        r0_multiplier=0.05)
    li, rays, dropped = vcm_mega.render_sample(
        scene, cam, key, 0, px, py, cfg=cfg, count_merge_dropped=True)
    li2, rays2 = vcm_mega.render_sample(scene, cam, key, 0, px, py,
                                        cfg=cfg)
    assert int(dropped) > 0
    assert int(rays) == int(rays2)
    np.testing.assert_array_equal(np.asarray(li), np.asarray(li2))
    # counter quiet when the cap is ample
    cfg_ok = vcm.VCMConfig(eye_depth=4, light_depth=4, max_per_cell=64)
    _, _, d2 = vcm_mega.render_sample(scene, cam, key, 0, px, py,
                                      cfg=cfg_ok, count_merge_dropped=True)
    assert int(d2) == 0
