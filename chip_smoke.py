#!/usr/bin/env python
"""Smoke test of the renderer on NVIDIA GPUs, through its own entry points.

One card (the default): every integrator renders through driver.Renderer at
the repository's real sizes, and each result is checked against a plain
reference in the same process:

  headline   1920x1080 Cornell box + 82k-triangle mesh, unidirectional,
             depth 8, persistent mega engine (configs/bunny_1080p.rendertron)
  vcm_800    the reference's shipped workload: 800x800 VCM, eye depth 16,
             light depth 10 (configs/reference_vcm_800.rendertron)
  naive_512, bidirectional_512, sppm_512
             the other integrators on their default engines
             (configs/cornell.rendertron); naive_512 also saves an .npz
             checkpoint and resumes from it exactly
  upload     the packed scene blocks read back bit-identical
  hits       ~1M closest-hit queries on the 82k-triangle scene, GPU against
             the CPU backend
  goldens    the five golden families against tests/golden/*.npy

  --four-cards runs only the sharded paths (parallel/sharding.py), each
  compared with one card rendering the same samples.

Every phase prints one JSON line with the device, the card's name and power
limit, compile seconds and peak device memory. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or when any phase fails, the script exits non-zero and
prints no such line.

Usage: python chip_smoke.py [--four-cards] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# --- tolerances -----------------------------------------------------------
# Image health (the verify skill's judge): every pixel finite, no NaN / Inf
# / negative sentinel, and most of the Cornell frame lit.
NONBLACK_MIN = 0.9
# Closest hits, GPU against XLA:CPU on the same rays. Both backends run the
# same float32 program, but each contracts and reorders the Moller-Trumbore
# and slab arithmetic its own way, so a ray through a shared edge or vertex
# may report either of two triangles at the same distance ("tie", |dt| <=
# HIT_TIE_RTOL * t), and a ray grazing a silhouette may hit on one backend
# and miss on the other. A corrupted id column (a bitcast int flushed or
# canonicalized) would disagree on a large share of rays instead.
HIT_TIE_RTOL = 1e-4
HIT_TIE_SHARE_MAX = 1e-3
HIT_OTHER_SHARE_MAX = 1e-4
HIT_T_RTOL = 1e-4
# Re-rendering the first dispatch of a phase. UNIDIRECTIONAL, NAIVE and
# SPPM add no float in a data-dependent order and must repeat bit for bit.
# BIDIRECTIONAL and VCM splat light-tracing paths onto shared pixels with
# scatter-adds, which XLA:GPU lowers to atomics, so the order of those
# additions, and the last bits of a pixel, change from run to run. Their
# bound is relative to the brightest pixel: reordering a sum of n
# non-negative float32 terms moves it by at most about n * 2^-24 of its
# value, while a splat lost or added twice moves a pixel by a whole path's
# contribution. Measured on an H100: one ulp of the peak (max |diff|
# 3.1e-5 for BDPT, 1.2e-7 for VCM).
SPLAT_INTEGRATORS = ("BIDIRECTIONAL", "VCM")
REPRO_SPLAT_RTOL = 1e-5
# Sharded against one card (--four-cards): the same samples; the only
# difference allowed is the order of the float additions in the splat and
# photon psums (parallel/sharding.py), the tolerance tests/test_sharding.py
# uses.
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-5


# --- helpers (backend-independent; tested on the CPU) ----------------------
def judge_accum(acc: np.ndarray) -> dict:
    """Health of an accumulation buffer [P, 3]: the pixels the image scrub
    would paint with the NaN / Inf / negative sentinel colours, and the
    share of lit pixels."""
    acc = np.asarray(acc, np.float32).reshape(-1, 3)
    nan = np.isnan(acc).any(-1)
    inf = np.isinf(acc).any(-1) & ~nan
    neg = (acc < 0).any(-1) & ~nan & ~inf
    nonblack = float((acc > 0).any(-1).mean())
    return {"nan_px": int(nan.sum()), "inf_px": int(inf.sum()),
            "neg_px": int(neg.sum()), "nonblack": nonblack,
            "healthy": bool(not (nan.any() or inf.any() or neg.any())
                            and nonblack > NONBLACK_MIN)}


def compare_hits(tri_a, t_a, tri_b, t_b) -> dict:
    """Agreement of two closest-hit results on the same rays."""
    tri_a, tri_b = np.asarray(tri_a), np.asarray(tri_b)
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    n = tri_a.size
    both = (tri_a >= 0) & (tri_b >= 0)
    differ = tri_a != tri_b
    tie = (differ & both
           & (np.abs(t_a - t_b) <= HIT_TIE_RTOL * np.maximum(np.abs(t_b), 1)))
    other = differ & ~tie
    same = both & ~differ
    t_rel = (np.abs(t_a - t_b) / np.maximum(np.abs(t_b), 1e-6))[same]
    res = {"rays": int(n), "hits": int((tri_b >= 0).sum()),
           "tie_share": float(tie.sum() / n),
           "other_share": float(other.sum() / n),
           "t_max_rel": float(t_rel.max()) if t_rel.size else 0.0}
    res["agree"] = bool(res["tie_share"] <= HIT_TIE_SHARE_MAX
                        and res["other_share"] <= HIT_OTHER_SHARE_MAX
                        and res["t_max_rel"] <= HIT_T_RTOL)
    return res


def bits_differ(a, b) -> int:
    """Number of 32-bit words that differ between two float32 arrays."""
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.uint32)
    return int(np.count_nonzero(a != b)) if a.shape == b.shape else a.size


def compare_repro(integrator: str, first, again) -> dict:
    """Reproducibility of a re-rendered dispatch: bit for bit, or within
    REPRO_SPLAT_RTOL of the brightest pixel for SPLAT_INTEGRATORS."""
    first = np.asarray(first, np.float32)
    again = np.asarray(again, np.float32)
    res = {"repro_words_differ": bits_differ(first, again),
           "repro_max_abs": float(np.abs(first - again).max())}
    if integrator in SPLAT_INTEGRATORS:
        res["repro_rel"] = (res["repro_max_abs"]
                            / max(float(np.abs(first).max()), 1e-30))
        res["repro_ok"] = bool(res["repro_rel"] <= REPRO_SPLAT_RTOL)
    else:
        res["repro_ok"] = res["repro_words_differ"] == 0
    return res


def probe_rays(lo, hi, n: int, eye, seed: int = 0):
    """n rays inside the box [lo, hi]: half from `eye` towards random
    points, half from random points in random directions."""
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * 0.98
    pts = mid + half * rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    o = np.repeat(np.asarray(eye, np.float32)[None], n, axis=0)
    m = n // 2
    o[m:] = mid + half * rs.uniform(-1, 1, (n - m, 3)).astype(np.float32)
    d = np.empty((n, 3), np.float32)
    d[:m] = pts[:m] - o[:m]
    d[m:] = rs.normal(size=(n - m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# --- phases ----------------------------------------------------------------
class Smoke:
    """Runs phases, prints one JSON line per phase, remembers failures.

    Programs compile ahead of time in a pool of threads (`submit`) while
    the main thread runs earlier phases; a phase waits for its own
    programs (`wait`). compile_s of a phase is XLA compilation (or a
    persistent-cache load) on the main thread only; the pool's own
    seconds (tracing, lowering and compiling) are reported per program."""

    def __init__(self, jax, card: str, workers: int = 1):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self.jax = jax
        self.card = card
        self.failed = []
        self.compile_s = 0.0
        self._main = threading.main_thread()
        self._pool = ThreadPoolExecutor(max_workers=max(workers, 1))
        self._jobs = {}
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        dev = jax.devices()[0]
        self.device = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}

    def _on_event(self, event, secs, **_):
        import threading
        if (event == "/jax/core/compile/backend_compile_duration"
                and threading.current_thread() is self._main):
            self.compile_s += secs

    def submit(self, name, fn, *args, **kw):
        """Compile `name` in the pool: fn(*args, **kw) -> jax Compiled."""
        def job():
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            return out, time.perf_counter() - t0
        self._jobs[name] = self._pool.submit(job)

    def wait(self, *names) -> dict:
        """Block until those of the named programs that were submitted are
        compiled (a compile error raises here, in the phase that needs the
        program). Returns their pool seconds."""
        return {n: self._jobs[n].result()[1] for n in names
                if n in self._jobs}

    def compiled(self, name):
        return self._jobs[name].result()[0]

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)

    def peak_bytes(self) -> int:
        return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
                   for d in self.jax.local_devices())

    def run(self, name, fn, *args):
        c0, t0 = self.compile_s, time.perf_counter()
        try:
            fields = fn(self, *args)
        except Exception as e:  # reported below and fails the run
            traceback.print_exc()
            fields = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        ok = bool(fields.pop("ok"))
        line = {"phase": name, "ok": ok, **fields,
                "compile_s": self.compile_s - c0,
                "wall_s": time.perf_counter() - t0,
                "peak_bytes_in_use": self.peak_bytes(),
                "device": self.device, "card": self.card}
        print(json.dumps(line), flush=True)
        if not ok:
            self.failed.append(name)


def _config(fname: str, out_dir: str, **overrides):
    from cudapathtracer_tpu.utils.config import load_config
    cfg = load_config(os.path.join(ROOT, "configs", fname))
    return dataclasses.replace(cfg, output_dir=out_dir, **overrides)


def _renderer(cfg):
    from cudapathtracer_tpu.driver import Renderer
    t0 = time.perf_counter()
    r = Renderer(cfg)
    r.build_s = time.perf_counter() - t0
    return r


def _render(smoke, r, timed: int, resume=None) -> dict:
    """Render through driver.Renderer `r`: one warm-up dispatch, `timed`
    measured samples, BMP + CSV, image judge, the first dispatch again
    (reproducibility, see SPLAT_INTEGRATORS) and, with `resume` (a second Renderer
    of the same config), an .npz checkpoint save and exact resume."""
    from cudapathtracer_tpu.driver import resolve_samples_per_dispatch
    from cudapathtracer_tpu.utils.metrics import RenderMetrics

    spd = resolve_samples_per_dispatch(r.cfg)
    quiet = dict(progressive=False, verbose=False)
    c0, t0 = smoke.compile_s, time.perf_counter()
    r.render(num_samples=spd, **quiet)
    first_s = time.perf_counter() - t0
    first = np.asarray(r.accum)
    r.metrics = RenderMetrics(pixels=r.metrics.pixels)
    t0 = time.perf_counter()
    r.render(num_samples=spd + timed, **quiet)
    dt = time.perf_counter() - t0
    res = {"integrator": r.cfg.integrator, "engine": r.cfg.engine,
           "width": r.cfg.width, "height": r.cfg.height,
           "triangles": int(r.scene.num_triangles),
           "samples_per_dispatch": spd, "scene_build_s": r.build_s,
           "first_dispatch_s": first_s,
           "first_dispatch_compile_s": smoke.compile_s - c0,
           "timed_samples": timed, "s_per_sample": dt / timed,
           "mrays_per_s": r.metrics.rays_traced / dt / 1e6,
           "rays_per_sample": r.metrics.rays_traced / timed}
    if r.cfg.integrator in ("VCM", "SPPM"):
        res["merge_dropped"] = int(r.metrics.merge_dropped or 0)
    r.save_final(0)
    res.update(judge_accum(np.asarray(r.accum)))
    ok = res["healthy"]
    # reproducibility: the first dispatch again, bit for bit
    done, kept = r.sample_count, r.accum
    r.accum, r.sample_count = r.accum * 0, 0
    r.render(num_samples=spd, **quiet)
    res.update(compare_repro(r.cfg.integrator, first, r.accum))
    ok = ok and res["repro_ok"]
    r.accum, r.sample_count = kept, done
    if resume is not None:
        ck = os.path.join(r.cfg.output_dir, f"{r.cfg.name}_resume.npz")
        r.save_checkpoint(ck)
        r.render(num_samples=done + spd, **quiet)
        resume.render(num_samples=done + spd, checkpoint_path=ck, **quiet)
        res["resume_words_differ"] = bits_differ(r.accum, resume.accum)
        ok = ok and res["resume_words_differ"] == 0
    res["ok"] = ok
    return res


def phase_headline(smoke, r):
    pool_s = smoke.wait("headline", "headline_counters")
    res = _render(smoke, r, timed=4)
    # the mega loop's own counters for sample 0 (a program of its own)
    _, _, it, fires, busy = smoke.compiled("headline_counters")(
        r.scene, r.camera, r.key, 0, r.px, r.py)
    res.update({"mega_iterations_per_sample": int(it),
                "mega_transitions_per_sample": int(fires),
                "mega_busy_lane_steps": int(busy),
                "pool_compile_s": pool_s})
    return res


def counters_program(r):
    """The headline's mega program with debug counters, compiled."""
    from cudapathtracer_tpu.models import unidirectional_mega
    return unidirectional_mega.render_sample.lower(
        r.scene, r.camera, r.key, 0, r.px, r.py, max_depth=r.cfg.max_depth,
        grid_w=r.cfg.width, debug_counters=True).compile()


def phase_render(smoke, name, r, timed, resume=None):
    pool_s = smoke.wait(name, f"{name}_resume")
    res = _render(smoke, r, timed=timed, resume=resume)
    res["pool_compile_s"] = pool_s
    return res


def phase_upload(smoke):
    import jax
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.native import native_available
    from cudapathtracer_tpu.scene.scene import pack_scene, upload_mismatches

    host, _ = pack_scene(builtin.cornell_with_bunny(), builtin_materials())
    dev = jax.device_put(host)
    bad = upload_mismatches(host, dev)
    # the device's own view of the bitcast id columns
    ids = jax.jit(lambda s: (s.tri_mat, s.tri_light, s.light_tri))(dev)
    want = [np.ascontiguousarray(host.tri_f32[:, 76]).view(np.int32),
            np.ascontiguousarray(host.tri_f32[:, 77]).view(np.int32),
            np.ascontiguousarray(host.light_f32[:, 16]).view(np.int32)]
    id_bad = sum(int(np.count_nonzero(np.asarray(g) != w))
                 for g, w in zip(ids, want))
    return {"ok": sum(bad.values()) == 0 and id_bad == 0,
            "words_differ": bad, "id_words_differ": id_bad,
            "triangles": int(host.tri_f32.shape[0]),
            "bvh_builder": "native" if native_available() else "numpy"}


def hit_inputs(n_rays=1 << 20):
    """(jitted closest-hit fn, {backend: device args}) for ~1M rays at the
    82k-triangle scene on the GPU and on the CPU backend."""
    import jax
    from cudapathtracer_tpu.ops import traverse8
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import pack_scene

    host, _ = pack_scene(builtin.cornell_with_bunny(), builtin_materials())
    b = np.asarray(host.node_bounds)[0]
    o, d = probe_rays(b[:3], b[3:], n_rays, eye=(0.0, 0.0, 1.0))
    args = {name: jax.device_put((host, o, d), dev) for name, dev in
            (("gpu", jax.devices()[0]), ("cpu", jax.devices("cpu")[0]))}
    return jax.jit(traverse8.closest_hit8), args


def phase_hits(smoke, hit, args):
    pool_s = smoke.wait(*[f"hits_{n}" for n in args])
    out = {}
    for name, a in args.items():
        t0 = time.perf_counter()
        h = hit(*a)
        out[name] = (np.asarray(h.tri), np.asarray(h.t))
        out[f"{name}_s"] = time.perf_counter() - t0
    gpu, cpu = list(args)[0], list(args)[1]
    res = compare_hits(out[gpu][0], out[gpu][1], out[cpu][0], out[cpu][1])
    res.update({"ok": res["agree"], "compared": [gpu, cpu],
                f"{gpu}_s": out[f"{gpu}_s"], f"{cpu}_s": out[f"{cpu}_s"],
                "pool_compile_s": pool_s})
    return res


GOLDEN_RUNS = (("uni", 128), ("mega", 128), ("mega", 64), ("bdpt", 128),
               ("vcm", 128), ("sppm", 128))


def phase_goldens(smoke, frame):
    from cudapathtracer_tpu import goldens
    pool_s = smoke.wait(*[f"golden_{n}_{w}" for n, w in GOLDEN_RUNS])
    errs = {f"{n}_w{w}" if n == "mega" else n:
            goldens.golden_rmse(frame, n, width=w) for n, w in GOLDEN_RUNS}
    return {"ok": max(errs.values()) < goldens.RMSE_MAX, "rmse": errs,
            "rmse_max": goldens.RMSE_MAX, "pool_compile_s": pool_s}


def run_one_card(smoke, out_dir):
    """Every one-card phase; the programs compile in the pool meanwhile."""
    from cudapathtracer_tpu import goldens

    os.makedirs(out_dir, exist_ok=True)
    cornell = lambda integ: _config(  # noqa: E731
        "cornell.rendertron", out_dir, integrator=integ,
        name=f"cornell_{integ.lower()}")
    rs = {"headline": _renderer(_config("bunny_1080p.rendertron", out_dir)),
          "vcm_800": _renderer(_config("reference_vcm_800.rendertron",
                                       out_dir)),
          "naive_512": _renderer(cornell("NAIVE_UNIDIRECTIONAL")),
          "naive_512_resume": _renderer(cornell("NAIVE_UNIDIRECTIONAL")),
          "bidirectional_512": _renderer(cornell("BIDIRECTIONAL")),
          "sppm_512": _renderer(cornell("SPPM"))}
    hit, hit_args = hit_inputs()
    frame = goldens.setup()
    # pool order = order of need
    for name, a in hit_args.items():
        smoke.submit(f"hits_{name}", lambda a=a: hit.lower(*a).compile())
    for n, w in GOLDEN_RUNS:
        smoke.submit(f"golden_{n}_{w}", goldens.compile_family, frame, n, w)
    smoke.submit("headline", rs["headline"].compile)
    smoke.submit("headline_counters", counters_program, rs["headline"])
    for name in ("vcm_800", "naive_512", "naive_512_resume",
                 "bidirectional_512", "sppm_512"):
        smoke.submit(name, rs[name].compile)

    smoke.run("upload", phase_upload)
    smoke.run("hits", phase_hits, hit, hit_args)
    smoke.run("goldens", phase_goldens, frame)
    smoke.run("headline", phase_headline, rs["headline"])
    smoke.run("vcm_800", phase_render, "vcm_800", rs["vcm_800"], 1)
    # naive path tracing only lights a pixel when a path finds the light
    # unaided: 128 spp for the judge's 90% lit share
    smoke.run("naive_512", phase_render, "naive_512", rs["naive_512"], 120,
              rs["naive_512_resume"])
    smoke.run("bidirectional_512", phase_render, "bidirectional_512",
              rs["bidirectional_512"], 8)
    # SPPM sees no emitter directly and lights the rest by merging alone
    smoke.run("sppm_512", phase_render, "sppm_512", rs["sppm_512"], 24)


def _sharded_uni_inputs():
    import jax.numpy as jnp
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene

    w, h = 1920, 1080
    scene, _ = build_scene(builtin.cornell_with_bunny(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    return {"w": w, "h": h, "depth": 8, "scene": scene, "cam": cam,
            "px": px.ravel(), "py": py.ravel()}


def phase_sharded_uni(smoke, x):
    """UNIDIRECTIONAL classic, 1920x1080, (tile 2, spp 2) mesh, one call
    (two samples), against one card rendering each shard's samples with
    the shard's own key."""
    import jax
    from cudapathtracer_tpu.models import unidirectional
    from cudapathtracer_tpu.parallel import sharding
    from cudapathtracer_tpu.utils import rng

    mesh = sharding.make_mesh(n_tile=2, n_spp=2)
    t0 = time.perf_counter()
    acc_s, done, rays_s = sharding.render_sharded(
        unidirectional.render_sample, mesh, x["scene"], x["cam"], x["w"],
        x["h"], 2, max_depth=x["depth"])
    sharded_s = time.perf_counter() - t0
    pool_s = smoke.wait("one_card_uni")
    key = rng.base_key()
    n_loc = x["w"] * x["h"] // 2
    acc_1 = np.zeros_like(acc_s)
    rays_1 = 0
    for ti in range(2):
        sl = slice(ti * n_loc, (ti + 1) * n_loc)
        for si in range(2):
            k = jax.random.fold_in(jax.random.fold_in(key, ti), si)
            li, rays = unidirectional.render_sample(
                x["scene"], x["cam"], k, si, x["px"][sl], x["py"][sl],
                max_depth=x["depth"])
            acc_1[sl] += np.asarray(li)
            rays_1 += int(rays)
    close = np.allclose(acc_s, acc_1, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    judge = judge_accum(acc_s)
    return {"ok": bool(close and done == 2 and rays_s == rays_1
                       and judge["healthy"]),
            "mesh": {"tile": 2, "spp": 2}, "width": x["w"],
            "height": x["h"], "samples": done, "rays_sharded": rays_s,
            "rays_one_card": rays_1,
            "max_abs_diff": float(np.abs(acc_s - acc_1).max()),
            "words_differ": bits_differ(acc_s, acc_1),
            "sharded_s": sharded_s, "pool_compile_s": pool_s, **judge}


def _sharded_vcm_inputs():
    import jax.numpy as jnp
    from cudapathtracer_tpu.models import vcm
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene

    w = h = 512
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    # the merge cap is high enough that it never binds, so the sharded and
    # the one-card render see the same photon candidates
    cfg = vcm.VCMConfig(eye_depth=8, light_depth=6, max_per_cell=64)
    return {"w": w, "h": h, "scene": scene, "cam": cam, "cfg": cfg,
            "px": px.ravel(), "py": py.ravel()}


def phase_sharded_vcm(smoke, x):
    """VCM classic with the photon all-gather (photon_axis="tile") on a
    (tile 4) mesh against the one-card render of the same sample."""
    from cudapathtracer_tpu.models import vcm
    from cudapathtracer_tpu.parallel import sharding
    from cudapathtracer_tpu.utils import rng

    mesh = sharding.make_mesh(n_tile=4, n_spp=1)
    t0 = time.perf_counter()
    acc_s, done, rays_s = sharding.render_sharded(
        vcm.render_sample, mesh, x["scene"], x["cam"], x["w"], x["h"], 1,
        splat=True, cfg=x["cfg"], photon_axis="tile")
    sharded_s = time.perf_counter() - t0
    pool_s = smoke.wait("one_card_vcm")
    li, rays_1, dropped = vcm.render_sample(
        x["scene"], x["cam"], rng.base_key(), 0, x["px"], x["py"],
        cfg=x["cfg"], count_merge_dropped=True)
    acc_1 = np.asarray(li)
    close = np.allclose(acc_s, acc_1, rtol=SHARD_RTOL, atol=SHARD_ATOL)
    judge = judge_accum(acc_s)
    return {"ok": bool(close and int(dropped) == 0 and judge["healthy"]
                       and int(rays_s) == int(rays_1)),
            "mesh": {"tile": 4, "spp": 1}, "width": x["w"], "height": x["h"],
            "eye_depth": x["cfg"].eye_depth,
            "light_depth": x["cfg"].light_depth,
            "merge_dropped_one_card": int(dropped),
            "rays_sharded": int(rays_s), "rays_one_card": int(rays_1),
            "max_abs_diff": float(np.abs(acc_s - acc_1).max()),
            "words_differ": bits_differ(acc_s, acc_1),
            "sharded_s": sharded_s, "pool_compile_s": pool_s, **judge}


def run_four_cards(smoke):
    """The sharded paths; their one-card references compile in the pool
    while the sharded programs compile and run."""
    from cudapathtracer_tpu.models import unidirectional, vcm
    from cudapathtracer_tpu.utils import rng

    xu, xv = _sharded_uni_inputs(), _sharded_vcm_inputs()
    n_loc = xu["w"] * xu["h"] // 2
    smoke.submit("one_card_uni", lambda: unidirectional.render_sample.lower(
        xu["scene"], xu["cam"], rng.base_key(), 0, xu["px"][:n_loc],
        xu["py"][:n_loc], max_depth=xu["depth"]).compile())
    smoke.submit("one_card_vcm", lambda: vcm.render_sample.lower(
        xv["scene"], xv["cam"], rng.base_key(), 0, xv["px"], xv["py"],
        cfg=xv["cfg"], count_merge_dropped=True).compile())
    smoke.run("sharded_uni_1080p", phase_sharded_uni, xu)
    smoke.run("sharded_vcm_512", phase_sharded_vcm, xv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--out", default=os.path.join(ROOT, "renders",
                                                  "chip_smoke"),
                    help="directory for the BMP / CSV / checkpoint files")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r}); refusing to run",
              file=sys.stderr)
        return 2
    from cudapathtracer_tpu.utils.compile_cache import enable_compile_cache
    from cudapathtracer_tpu.utils.host import COMPILE_WORKERS, card_info

    cache = enable_compile_cache()
    card = card_info()
    print(f"card: {card}", flush=True)
    smoke = Smoke(jax, card, COMPILE_WORKERS)
    print(json.dumps({"phase": "setup", "compile_cache": cache,
                      "jax": jax.__version__,
                      "xla_flags": os.environ.get("XLA_FLAGS", ""),
                      "compile_workers": COMPILE_WORKERS,
                      "device": smoke.device, "card": card}), flush=True)
    try:
        if args.four_cards:
            if smoke.device["count"] < 4:
                print("chip_smoke: --four-cards needs four GPUs, found "
                      f"{smoke.device['count']}", file=sys.stderr)
                return 2
            run_four_cards(smoke)
        else:
            run_one_card(smoke, args.out)
    finally:
        smoke.close()
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": smoke.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
