import os

import numpy as np
import pytest

from cudapathtracer_tpu.driver import Renderer
from cudapathtracer_tpu.utils.config import MeshConfig, RenderConfig
from cudapathtracer_tpu.utils.image import load_bmp, rmse


def make_cfg(tmp_path, integrator="UNIDIRECTIONAL", **kw):
    return RenderConfig(
        width=16, height=16, name="t", integrator=integrator, sample_count=3,
        max_depth=4, bvh_leaf_size=2, pinhole_camera=True,
        cam_pos=(0.0, 0.0, 1.0), cam_fov=60.0,
        bdpt_eye_depth=4, bdpt_light_depth=3, bdpt_light_trace=True,
        bdpt_nee=True, bdpt_naive=True, bdpt_connection=True,
        bdpt_do_mis=True, vcm_merge_const=0.7,
        vcm_initial_merge_radius_multiplier=0.02,
        meshes=[MeshConfig(path="builtin:cornell_blocks")],
        output_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("integrator", ["NAIVE_UNIDIRECTIONAL",
                                        "UNIDIRECTIONAL", "BIDIRECTIONAL",
                                        "VCM", "SPPM"])
def test_all_integrators_end_to_end(tmp_path, integrator):
    r = Renderer(make_cfg(tmp_path, integrator))
    img = r.render(num_samples=2, progressive=False, verbose=False)
    arr = img.pixels
    assert arr.shape == (16, 16, 3)
    assert np.isfinite(arr).all()
    assert arr.mean() > 0


def test_progressive_save_and_bmp_roundtrip(tmp_path):
    r = Renderer(make_cfg(tmp_path))
    r.render(num_samples=2, progressive=False, verbose=False)
    img = r.save_final(0)
    path = os.path.join(str(tmp_path), "t0.bmp")
    assert os.path.exists(path)
    back = load_bmp(path, decode_srgb=False)
    assert back.shape == (16, 16, 3)
    # saved image is clipped [0,1]; compare against the clipped original
    assert rmse(back, np.clip(img.post_processed(), 0, 1)) < 0.01
    assert os.path.exists(os.path.join(str(tmp_path), "t0.csv"))


@pytest.mark.smoke
def test_checkpoint_resume_exact(tmp_path):
    """Resume must reproduce the uninterrupted render bit-for-bit — the
    capability the reference lacks (SURVEY.md §5.4)."""
    ck = os.path.join(str(tmp_path), "ck.npz")
    r1 = Renderer(make_cfg(tmp_path))
    r1.render(num_samples=4, progressive=False, verbose=False)
    full = np.asarray(r1.accum)

    r2 = Renderer(make_cfg(tmp_path))
    r2.render(num_samples=2, progressive=False, verbose=False)
    r2.save_checkpoint(ck)
    r3 = Renderer(make_cfg(tmp_path))
    r3.load_checkpoint(ck)
    assert r3.sample_count == 2
    r3.render(num_samples=4, progressive=False, verbose=False)
    np.testing.assert_array_equal(np.asarray(r3.accum), full)


def test_checkpoint_mismatch_rejected(tmp_path):
    ck = os.path.join(str(tmp_path), "ck.npz")
    r1 = Renderer(make_cfg(tmp_path))
    r1.render(num_samples=1, progressive=False, verbose=False)
    r1.save_checkpoint(ck)
    r2 = Renderer(make_cfg(tmp_path, seed=7))
    with pytest.raises(ValueError):
        r2.load_checkpoint(ck)


def test_checkpoint_orbax_roundtrip(tmp_path):
    """Non-.npz checkpoint paths select the Orbax directory format;
    resume must be bit-exact like npz."""
    ck = os.path.join(str(tmp_path), "ck_orbax")
    r1 = Renderer(make_cfg(tmp_path))
    r1.render(num_samples=2, progressive=False, verbose=False)
    r1.save_checkpoint(ck)
    assert os.path.isdir(ck)

    r2 = Renderer(make_cfg(tmp_path))
    r2.load_checkpoint(ck)
    assert r2.sample_count == 2
    np.testing.assert_array_equal(np.asarray(r2.accum), np.asarray(r1.accum))

    r3 = Renderer(make_cfg(tmp_path, seed=7))
    with pytest.raises(ValueError):
        r3.load_checkpoint(ck)

    # overwrite-in-place works (progressive saves hit the same path)
    r1.render(num_samples=3, progressive=False, verbose=False)
    r1.save_checkpoint(ck)
    r4 = Renderer(make_cfg(tmp_path))
    r4.load_checkpoint(ck)
    assert r4.sample_count == 3
