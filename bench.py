#!/usr/bin/env python
"""Benchmark harness (GPU only).

Emits ONE JSON line per benchmark: the 1080p Cornell + 82k-triangle mesh
headline (mega-wavefront unidirectional), the reference's shipped workload
(800^2 VCM, eye depth 16, light depth 10), the 512^2 configs 1/2/4, and every
integrator (naive/uni/mega/BDPT/VCM/SPPM, classic and mega engines) at 256^2.
Every line names the device (platform, device_kind, count) and the card
(nvidia-smi name and power limit). Without a GPU the harness refuses to run.

The headline is measured and emitted first and re-emitted as the final line
for tail parsers. The suite lines are compiled ahead of time by a pool of
threads in this process (jit(...).lower().compile()), then measured one
after another on a quiet host once the pool has drained. The whole run works
under a wall-clock deadline (--deadline-s) that skips remaining lines
instead of dying, and each line is exception-contained.

Timing: one window of `spp` samples after a warm-up dispatch, ended by
block_until_ready on the accumulated image.

Usage: python bench.py [--small] [--spp N] [--headline-only]
                       [--skip-suite-slow] [--deadline-s S]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

_T0 = time.monotonic()
_DEVICE: dict = {}


def _elapsed():
    return time.monotonic() - _T0


def _emit(result):
    print(json.dumps({**result, **_DEVICE}), flush=True)


def _grid(w, h):
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    return px.ravel(), py.ravel()


def _aot_step(inner, ctx, batch):
    """AOT-compile `inner(scene,cam,key,s,px,py)` (batched device-side when
    batch > 1 — models/batch.py, bit-identical) WITHOUT executing it.

    Returns step(s0) -> (li, rays, ...) advancing `batch` samples. The
    compile runs wherever the caller is (a pool thread, for the suite);
    execution stays with the measuring thread."""
    scene, cam, key, px, py = ctx
    if batch > 1:
        from cudapathtracer_tpu.models.batch import make_batched
        bf = make_batched(inner)
        compiled = bf.lower(scene, cam, key, jnp.int32(0), px, py,
                            k=batch).compile()
    else:
        jf = jax.jit(lambda sc, c, k2, s, ipx, ipy:
                     inner(sc, c, k2, s, ipx, ipy))
        compiled = jf.lower(scene, cam, key, jnp.int32(0), px,
                            py).compile()
    return lambda s0: compiled(scene, cam, key, jnp.int32(s0), px, py)


def _classic_chunked_step(scene, cam, key, px, py, nchunks):
    """The classic engine's headline step: each sample renders the frame
    as `nchunks` equal runs of pixels through one compiled program."""
    from cudapathtracer_tpu.models import unidirectional
    csz = px.shape[0] // nchunks
    chunks = [(px[i * csz:(i + 1) * csz], py[i * csz:(i + 1) * csz])
              for i in range(nchunks)]
    compiled = jax.jit(
        lambda sc, c, k, s, ipx, ipy: unidirectional.render_sample(
            sc, c, k, s, ipx, ipy, max_depth=8)).lower(
        scene, cam, key, jnp.int32(0), *chunks[0]).compile()

    def step(s0):
        outs = [compiled(scene, cam, key, jnp.int32(s0), cx, cy)
                for cx, cy in chunks]
        return (jnp.concatenate([o[0] for o in outs]),
                sum(o[1] for o in outs))
    return step


def _measure(step, spp, batch, metric, extra=None):
    """Time `spp` samples of a prebuilt step (`batch` samples per call)
    after one warm-up call."""
    k = max(batch, 1)
    jax.block_until_ready(step(0))
    acc = None
    rays = jnp.zeros((), jnp.int32)
    dropped = None
    t0 = time.perf_counter()
    for s in range(1, 1 + spp, k):
        out = step(s)
        acc = out[0] if acc is None else acc + out[0]
        rays = rays + out[1]
        if len(out) > 2:
            dropped = out[2] if dropped is None else dropped + out[2]
    img = np.asarray(jax.block_until_ready(acc))
    dt = time.perf_counter() - t0
    if not np.isfinite(img).all():
        raise FloatingPointError(f"NaN/Inf in benchmark render {metric!r}")
    rays = int(rays)
    result = {"metric": metric, "value": rays / dt / 1e6, "unit": "Mrays/s",
              "spp": spp, "spp_per_s": spp / dt, "s_per_sample": dt / spp,
              "rays": rays, "seconds": dt}
    if dropped is not None:
        result["merge_dropped"] = int(dropped)
    result.update(extra or {})
    return result


def _error_line(name, e):
    traceback.print_exc(file=sys.stderr)
    _emit({"metric": name, "value": 0, "unit": "error",
           "error": f"{type(e).__name__}: {e}"})


def run_suite(args, key, deadline_s):
    """Suite lines, compiled by a thread pool and measured afterwards in
    priority order (photon family first)."""
    from concurrent.futures import ThreadPoolExecutor, wait

    from cudapathtracer_tpu.utils.host import COMPILE_WORKERS
    from cudapathtracer_tpu.models import (bdpt, bdpt_mega, naive,
                                           unidirectional,
                                           unidirectional_mega, vcm,
                                           vcm_mega)
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene

    mats = builtin_materials()
    # small frames: several samples per dispatch (bit-identical —
    # tests/test_batch.py)
    batch = args.batch if args.batch > 0 else min(args.spp, 4)

    scene, _ = build_scene(builtin.cornell_with_blocks(), mats)
    scene2, _ = build_scene(builtin.cornell_with_spheres(), mats)
    mesh4 = builtin.cornell_with_bunny(subdivisions=4, bunny_mat=7)
    scene4, _ = build_scene(mesh4, mats)

    w = h = 512
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(w, h)
    ws = hs = 256
    cam_s = Camera.pinhole((0.0, 0.0, 1.0), ws, hs, 0.0, 0.0, 0.0, 60.0)
    pxs, pys = _grid(ws, hs)
    spp_s = max(args.spp // 2, 1)
    wr = hr = 800
    cam_r = Camera.pinhole((0.0, 0.0, 1.0), wr, hr, 0.0, 0.0, 0.0, 60.0)
    pxr, pyr = _grid(wr, hr)
    spp_r = max(args.spp // 2, 1)

    def mega_inner(sc, c, k, s, ipx, ipy):
        # width 0 = engine default (MEGA_WIDTH)
        return unidirectional_mega.render_sample(
            sc, c, k, s, ipx, ipy, max_depth=8,
            width=min(args.width, int(ipx.shape[0])), grid_w=c.width)

    vcfg = vcm.VCMConfig(eye_depth=6, light_depth=4)
    scfg = vcm.VCMConfig(eye_depth=6, light_depth=4, light_trace=False,
                         nee=False, naive=False, connection=False,
                         do_mis=False, do_sppm=True)
    vcfg_r = vcm.VCMConfig(eye_depth=16, light_depth=10)
    bcfg = bdpt.BDPTConfig(eye_depth=6, light_depth=4)
    sw = min(args.width, ws * hs)  # 0 = engine default
    bs = min(batch, spp_s)
    small = (scene, cam_s, key, pxs, pys)

    # (name, spp, batch, inner, ctx) — priority order
    specs = [
        ("config6 reference-shipped VCM 800x800 eye16/light10 mega", spp_r,
         1, lambda sc, c, k, s, ipx, ipy: vcm_mega.render_sample(
             sc, c, k, s, ipx, ipy, cfg=vcfg_r, grid_w=wr,
             count_merge_dropped=True),
         (scene, cam_r, key, pxr, pyr)),
        ("integrator vcm-mega 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: vcm_mega.render_sample(
             sc, c, k, s, ipx, ipy, cfg=vcfg, width=sw, grid_w=ws), small),
        ("integrator sppm-mega 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: vcm_mega.render_sample(
             sc, c, k, s, ipx, ipy, cfg=scfg, width=sw, grid_w=ws), small),
        ("config1 Cornell 512x512 mega", args.spp, batch, mega_inner,
         (scene, cam, key, px, py)),
        ("config2 specular mirror+glass 512x512 mega", args.spp, batch,
         mega_inner, (scene2, cam, key, px, py)),
        (f"config4 NEE+GGX steel mesh({mesh4.num_triangles}) 512x512 mega",
         args.spp, batch, mega_inner, (scene4, cam, key, px, py)),
        ("integrator vcm 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: vcm.render_sample(
             sc, c, k, s, ipx, ipy, cfg=vcfg), small),
        ("integrator sppm 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: vcm.render_sample(
             sc, c, k, s, ipx, ipy, cfg=scfg), small),
        ("integrator naive 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: naive.render_sample(
             sc, c, k, s, ipx, ipy, max_depth=6), small),
        ("integrator unidirectional-classic 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: unidirectional.render_sample(
             sc, c, k, s, ipx, ipy, max_depth=6), small),
        ("integrator unidirectional-mega 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: unidirectional_mega.render_sample(
             sc, c, k, s, ipx, ipy, max_depth=6, width=sw, grid_w=ws),
         small),
        ("integrator bdpt 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: bdpt.render_sample(
             sc, c, k, s, ipx, ipy, cfg=bcfg), small),
        ("integrator bdpt-mega 256x256 Cornell", spp_s, bs,
         lambda sc, c, k, s, ipx, ipy: bdpt_mega.render_sample(
             sc, c, k, s, ipx, ipy, cfg=bcfg, width=sw, grid_w=ws), small),
    ]
    if args.skip_suite_slow:
        slow = ("vcm", "sppm", "bdpt", "config6")
        specs = [s for s in specs if not any(t in s[0] for t in slow)]

    pool = ThreadPoolExecutor(max_workers=COMPILE_WORKERS)
    futs = {pool.submit(_aot_step, inner, ctx, bat): name
            for name, _spp, bat, inner, ctx in specs}
    _, pending = wait(futs, timeout=max(deadline_s - _elapsed() - 60, 0))
    pool.shutdown(wait=False, cancel_futures=True)
    steps = {futs[f]: f for f in futs if f not in pending}
    skipped = [futs[f] for f in pending]
    for name, spp, bat, _inner, _ctx in specs:
        if name not in steps:
            continue
        if deadline_s - _elapsed() < 20:
            skipped.append(name)
            continue
        try:
            _emit(_measure(steps[name].result(), spp, bat, name))
        except Exception as e:  # one bad line must not kill the suite
            _error_line(name, e)
    return skipped


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="256x256 headline quick mode")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the suite, emit only the 1080p headline")
    ap.add_argument("--skip-suite-slow", action="store_true",
                    help="skip the BDPT/VCM/SPPM integrator benches")
    ap.add_argument("--classic", action="store_true",
                    help="classic per-bounce wavefront for the headline "
                         "(20 runs of pixels per sample)")
    ap.add_argument("--width", type=int, default=0,
                    help="mega wavefront lane count; 0 = engine default "
                         "(models/unidirectional_mega.MEGA_WIDTH)")
    ap.add_argument("--batch", type=int, default=0,
                    help="samples per device dispatch for the suite lines "
                         "(0 = auto: min(spp, 4))")
    ap.add_argument("--deadline-s", type=float, default=1200,
                    help="wall-clock budget; once spent, remaining suite "
                         "lines are skipped (not errors) and the run still "
                         "exits 0 with the headline captured")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"bench.py: JAX found no GPU (backend "
              f"{jax.default_backend()!r}); refusing to run",
              file=sys.stderr)
        return 2
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene
    from cudapathtracer_tpu.utils import rng
    from cudapathtracer_tpu.utils.compile_cache import enable_compile_cache
    from cudapathtracer_tpu.utils.host import card_info

    enable_compile_cache()
    dev = jax.devices()[0]
    _DEVICE["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
    _DEVICE["card"] = card_info()
    key = rng.base_key()

    # ---- headline: 1080p Cornell + mesh, measured and emitted first ----
    if args.small:
        w, h, subdiv = 256, 256, 4
    else:
        w, h, subdiv = 1920, 1080, 6  # ~82k tris
    t0 = time.perf_counter()
    mesh = builtin.cornell_with_bunny(subdivisions=subdiv)
    scene, _ = build_scene(mesh, builtin_materials())
    t_scene = time.perf_counter() - t0
    cam = Camera.pinhole((0.0, 0.0, 1.0), w, h, 0.0, 0.0, 0.0, 60.0)
    px, py = _grid(w, h)
    t0 = time.perf_counter()
    if args.classic:
        name = (f"Mrays/s unidirectional-classic {w}x{h} "
                f"Cornell+mesh({mesh.num_triangles} tris)")
        step = _classic_chunked_step(scene, cam, key, px, py,
                                     1 if args.small else 20)
    else:
        from cudapathtracer_tpu.models import unidirectional_mega
        name = (f"Mrays/s unidirectional {w}x{h} "
                f"Cornell+mesh({mesh.num_triangles} tris)")
        width = min(args.width, w * h)

        def inner(sc, c, k, s, ipx, ipy):
            return unidirectional_mega.render_sample(
                sc, c, k, s, ipx, ipy, max_depth=8, width=width,
                grid_w=c.width)
        step = _aot_step(inner, (scene, cam, key, px, py), 1)
    t_compile = time.perf_counter() - t0
    result = _measure(step, args.spp, 1, name,
                      extra={"scene_build_s": t_scene,
                             "compile_s": t_compile})
    _emit(result)

    skipped = []
    if not (args.small or args.headline_only):
        skipped = run_suite(args, key, args.deadline_s)

    final = dict(result, reemit=True, bench_wall_s=_elapsed())
    if skipped:
        final["suite_skipped"] = skipped
    _emit(final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
