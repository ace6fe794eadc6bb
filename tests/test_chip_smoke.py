"""chip_smoke.py's checks, exercised on the CPU at small sizes.

The script itself refuses to run without a GPU; its phase helpers (the
image judge, the hit-id comparison, the bit-exact upload check, the golden
check) are backend-independent and are tested here. Tests that need the
card are marked `gpu` and skip inside the `gpu` fixture."""

import jax
import numpy as np
import pytest

import chip_smoke


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke.Smoke(jax, "cpu (test)")


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok": true' not in out.out
    assert "no GPU" in out.err


def test_judge_accum():
    acc = np.full((100, 3), 0.5, np.float32)
    assert chip_smoke.judge_accum(acc)["healthy"]
    acc[:5] = 0.0                       # 95% lit: still healthy
    assert chip_smoke.judge_accum(acc)["healthy"]
    acc[:20] = 0.0                      # 80% lit: too dark
    j = chip_smoke.judge_accum(acc)
    assert not j["healthy"] and j["nonblack"] == pytest.approx(0.8)
    for bad, field in ((np.nan, "nan_px"), (np.inf, "inf_px"),
                       (-1.0, "neg_px")):
        acc = np.full((100, 3), 0.5, np.float32)
        acc[7, 1] = bad
        j = chip_smoke.judge_accum(acc)
        assert j[field] == 1 and not j["healthy"]


def test_compare_hits_tolerances():
    n = 100_000
    rs = np.random.RandomState(0)
    tri = rs.randint(-1, 5000, n).astype(np.int32)
    t = rs.uniform(0.1, 3.0, n).astype(np.float32)
    assert chip_smoke.compare_hits(tri, t, tri, t)["agree"]
    # a few ties (other triangle at the same distance) are allowed
    tri2 = tri.copy()
    hit = np.nonzero(tri >= 0)[0]
    tri2[hit[:50]] = (tri2[hit[:50]] + 1) % 5000
    r = chip_smoke.compare_hits(tri2, t, tri, t)
    assert r["agree"] and r["tie_share"] == pytest.approx(50 / n)
    # a corrupted id column is not
    r = chip_smoke.compare_hits(np.zeros_like(tri), t, tri, t)
    assert not r["agree"]
    # nor are hits at different distances
    t2 = t.copy()
    t2[hit[:50]] *= 1.01
    r = chip_smoke.compare_hits(tri2, t2, tri, t)
    assert not r["agree"] and r["other_share"] == pytest.approx(50 / n)


def test_bits_differ_sees_nan_payloads():
    ints = np.array([-1, 0, 1, 0x7F800001, 12345], np.int32)
    a = ints.view(np.float32)
    b = a.copy()
    assert chip_smoke.bits_differ(a, b) == 0
    # canonicalizing the all-ones NaN (int -1) is invisible to a float
    # compare but not to the bit compare
    b.view(np.int32)[0] = 0x7FC00000
    assert chip_smoke.bits_differ(a, b) == 1


def test_compare_repro_per_integrator():
    rs = np.random.RandomState(0)
    first = rs.uniform(0, 300, (1000, 3)).astype(np.float32)
    ulp = first.copy()
    ulp[3, 0] = np.nextafter(ulp[3, 0], np.float32(np.inf))
    for integ in ("UNIDIRECTIONAL", "NAIVE_UNIDIRECTIONAL", "SPPM"):
        assert chip_smoke.compare_repro(integ, first, first)["repro_ok"]
        r = chip_smoke.compare_repro(integ, first, ulp)
        assert not r["repro_ok"] and r["repro_words_differ"] == 1
    # splatting integrators: summation order moves the last bits only
    for integ in chip_smoke.SPLAT_INTEGRATORS:
        r = chip_smoke.compare_repro(integ, first, ulp)
        assert r["repro_ok"] and r["repro_rel"] > 0
        lost = first.copy()
        lost[5, 2] *= 0.5                 # a splat lost, not reordered
        assert not chip_smoke.compare_repro(integ, first, lost)["repro_ok"]


def test_render_phase_cpu(smoke, tmp_path):
    # the phase body on a tiny classic render: BMP + CSV, reproducibility
    # and an exact checkpoint resume
    cfg = chip_smoke._config(
        "cornell.rendertron", str(tmp_path), name="tiny",
        integrator="NAIVE_UNIDIRECTIONAL", engine="classic", width=16,
        height=16, max_depth=3)
    res = chip_smoke._render(smoke, chip_smoke._renderer(cfg), timed=2,
                             resume=chip_smoke._renderer(cfg))
    assert res["repro_ok"] and res["repro_words_differ"] == 0
    assert res["resume_words_differ"] == 0
    assert res["width"] == 16 and res["rays_per_sample"] > 0
    assert res["nan_px"] == res["inf_px"] == res["neg_px"] == 0
    assert sorted(p.suffix for p in tmp_path.glob("tiny0.*")) == [".bmp",
                                                                  ".csv"]


def test_probe_rays_inside_box():
    o, d = chip_smoke.probe_rays((-1, -1, -1), (1, 1, 1), 1000,
                                 eye=(0.0, 0.0, 0.9))
    assert o.shape == d.shape == (1000, 3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-5)
    assert (np.abs(o) <= 1).all()


def test_phase_upload_cpu(smoke):
    res = chip_smoke.phase_upload(smoke)
    assert res["ok"], res
    assert res["bvh_builder"] in ("native", "numpy")


def test_phase_hits_cpu(smoke):
    # CPU against CPU: the comparison machinery must report exact agreement
    hit, args = chip_smoke.hit_inputs(n_rays=4096)
    smoke.submit("hits_gpu", lambda: hit.lower(*args["gpu"]).compile())
    res = chip_smoke.phase_hits(smoke, hit, args)
    assert res["ok"] and res["tie_share"] == 0 and res["other_share"] == 0
    assert res["rays"] == 4096 and "hits_gpu" in res["pool_compile_s"]


def test_golden_check_flags_drift():
    from cudapathtracer_tpu import goldens
    frame = goldens.setup()
    assert goldens.golden_rmse(frame, "uni") < goldens.RMSE_MAX
    # a different estimator against the same golden is drift
    img = goldens.render(frame, "mega")
    ref = np.load(f"{goldens.GOLDEN_DIR}/cornell_uni_16x16_8spp.npy")
    assert np.sqrt(np.mean((img - ref) ** 2)) > goldens.RMSE_MAX


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu, smoke):
    from cudapathtracer_tpu import goldens
    assert chip_smoke.phase_upload(smoke)["ok"]
    assert chip_smoke.phase_hits(smoke, *chip_smoke.hit_inputs())["ok"]
    assert chip_smoke.phase_goldens(smoke, goldens.setup())["ok"]
