#!/usr/bin/env python
"""Nightly-style cross-integrator agreement harness: render a battery of
scenes — diffuse, specular, textured leaf (alpha-cutout transmission map),
nested dielectric, SDS glass core — with every integrator at equal sample
budget and report relative RMSE against a high-spp reference rendered by the
estimator best suited to the scene (unidirectional for NEE-reachable scenes,
VCM for SDS).

Emits one JSON line per (scene, integrator) so regressions in ANY
estimator/scene pairing are visible round over round:
  {"scene": ..., "integrator": ..., "rel_rmse": ..., "spp": ...}

Usage: python tools/nightly_rmse.py [--size 128] [--spp 64] [--ref-spp 512]
       [--scenes diffuse,specular,...] [--integrators uni,mega,...]

With --gate, per-(scene, integrator) mean_ratio thresholds ARE asserted
where the estimator is appropriate, and the run exits nonzero on any
violation. SPPM is additionally reported (and gated)
against the SPPM-REACHABLE reference — the uni reference minus the
emission at directly-visible light pixels — because reference-parity SPPM
(main.cu:325-333: naive/NEE/MIS all off) cannot see emitters directly;
its 0.38x raw ratio on emission-heavy scenes is flag behavior, not an
estimator bug (demonstrated in tools/debug_merge3.py: unweighted merge is
0.95-1.01x the reachable truth).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

# mean_ratio gates, keyed (scene, integrator); applied with --gate where
# the estimator is appropriate for the scene. Bands reflect the
# estimator's variance at the default budget (spp 24-64, 128^2), centered
# on the ratios the harness measured when the gates were set.
GATES = {
    ("diffuse", "naive"): (0.90, 1.10), ("diffuse", "uni"): (0.95, 1.05),
    ("diffuse", "mega"): (0.95, 1.05), ("diffuse", "bdpt"): (0.92, 1.08),
    ("diffuse", "bdpt-mega"): (0.92, 1.08),
    ("diffuse", "vcm"): (0.95, 1.05), ("diffuse", "vcm-mega"): (0.95, 1.05),
    ("specular", "naive"): (0.90, 1.10), ("specular", "uni"): (0.95, 1.05),
    ("specular", "mega"): (0.95, 1.05), ("specular", "bdpt"): (0.92, 1.08),
    ("specular", "bdpt-mega"): (0.92, 1.08),
    ("specular", "vcm"): (0.93, 1.07), ("specular", "vcm-mega"): (0.93, 1.07),
    ("leaf", "naive"): (0.90, 1.10), ("leaf", "uni"): (0.95, 1.05),
    ("leaf", "mega"): (0.95, 1.05), ("leaf", "bdpt"): (0.92, 1.08),
    ("leaf", "bdpt-mega"): (0.92, 1.08),
    ("leaf", "vcm"): (0.95, 1.05), ("leaf", "vcm-mega"): (0.95, 1.05),
    # nested/SDS: reference is VCM itself; only the photon family is
    # appropriate (uni/bdpt cannot reach SDS paths and legitimately differ)
    ("nested", "vcm"): (0.90, 1.10), ("nested", "vcm-mega"): (0.90, 1.10),
    ("sds", "vcm"): (0.90, 1.10), ("sds", "vcm-mega"): (0.90, 1.10),
    # SPPM: gated on ratio_vs_reachable (see module doc), uni-ref scenes
    ("diffuse", "sppm"): (0.80, 1.15), ("specular", "sppm"): (0.80, 1.20),
    ("leaf", "sppm"): (0.80, 1.15),
}


def build_scenes(which):
    from cudapathtracer_tpu.scene import builtin, textures
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene
    from cudapathtracer_tpu.utils.obj import MeshData

    out = {}
    if "diffuse" in which:
        out["diffuse"] = (build_scene(builtin.cornell_with_blocks(),
                                      builtin_materials())[0], "uni")
    if "specular" in which:
        out["specular"] = (build_scene(builtin.cornell_with_spheres(),
                                       builtin_materials())[0], "uni")
    if "leaf" in which:
        # cornell + a leaf-material quad (material 13: textured albedo +
        # transmission map -> exercises resolve_transmission at every
        # dispatch site, reflectors.cuh:573-578 parity)
        b = textures.AtlasBuilder()
        wins = [b.add_image(builtin.checker_texture(16).reshape(16, 16, 3))
                for _ in range(4)]
        mats = builtin_materials(wins)
        m = builtin.cornell_box()
        pts = np.asarray([[-0.6, -0.2, -0.2], [0.6, -0.2, -0.2],
                          [0.6, 0.6, -0.4], [-0.6, 0.6, -0.4]], np.float32)
        uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        m.add(pts, idx, 13, uvs=uvs, uv_idx=idx)
        out["leaf"] = (build_scene(m, mats, textures=b.build())[0], "uni")
    if "nested" in which:
        out["nested"] = (build_scene(builtin.cornell_pool(),
                                     builtin_materials())[0], "vcm")
    if "sds" in which:
        out["sds"] = (build_scene(builtin.cornell_glass_core(),
                                  builtin_materials())[0], "vcm")
    return out


def make_steps(size, width):
    from cudapathtracer_tpu.models import (bdpt, bdpt_mega, naive,
                                           unidirectional,
                                           unidirectional_mega, vcm,
                                           vcm_mega)

    bcfg = bdpt.BDPTConfig(eye_depth=8, light_depth=6)
    vcfg = vcm.VCMConfig(eye_depth=8, light_depth=6)
    scfg = vcm.VCMConfig(eye_depth=8, light_depth=6, light_trace=False,
                         nee=False, naive=False, connection=False,
                         do_mis=False, do_sppm=True)
    w = width

    steps = {
        "naive": lambda sc, c, k, s, px, py: naive.render_sample(
            sc, c, k, s, px, py, max_depth=8),
        "uni": lambda sc, c, k, s, px, py: unidirectional.render_sample(
            sc, c, k, s, px, py, max_depth=8),
        "mega": lambda sc, c, k, s, px, py: unidirectional_mega.render_sample(
            sc, c, k, s, px, py, max_depth=8,
            width=min(w, int(px.shape[0])), grid_w=size),
        "bdpt": lambda sc, c, k, s, px, py: bdpt.render_sample(
            sc, c, k, s, px, py, cfg=bcfg),
        "bdpt-mega": lambda sc, c, k, s, px, py: bdpt_mega.render_sample(
            sc, c, k, s, px, py, cfg=bcfg,
            width=min(w, int(px.shape[0])), grid_w=size),
        "vcm": lambda sc, c, k, s, px, py: vcm.render_sample(
            sc, c, k, s, px, py, cfg=vcfg),
        "vcm-mega": lambda sc, c, k, s, px, py: vcm_mega.render_sample(
            sc, c, k, s, px, py, cfg=vcfg,
            width=min(w, int(px.shape[0])), grid_w=size),
        "sppm": lambda sc, c, k, s, px, py: vcm.render_sample(
            sc, c, k, s, px, py, cfg=scfg),
    }
    # one jitted program per integrator and scene shape, shared by the
    # compile pool and the render loop
    return {name: jax.jit(fn) for name, fn in steps.items()}


def render(step, scene, cam, key, px, py, spp):
    acc = np.zeros((px.shape[0], 3), np.float64)
    for s in range(spp):
        li, _ = step(scene, cam, key, s, px, py)
        acc += np.asarray(li, np.float64)
    return acc / spp


def visible_emission(scene, cam, key, px, py, spp=8):
    """Mean emission at the FIRST eye hit (the part of the image
    reference-parity SPPM cannot see; see module doc)."""
    import jax

    from cudapathtracer_tpu.models import paths
    from cudapathtracer_tpu.ops import traverse
    from cudapathtracer_tpu.utils import rng as rng_mod

    pid = rng_mod.pixel_ids(px, py)

    # one jit for the whole per-sample computation
    @jax.jit
    def one(s):
        ekey = jax.random.fold_in(rng_mod.sample_key(key, s), 2)
        estart, _ = paths.start_eye_walk(scene, cam, ekey, px, py, ids=pid)
        hit = traverse.closest_hit(scene, estart.o, estart.d)
        info = traverse.interpolate_hit(scene, estart.o, estart.d, hit)
        is_l = (hit.valid & (info["light_ind"] >= 0) & ~info["backface"])
        le = scene.light_emission[jnp.maximum(info["light_ind"], 0)]
        return jnp.where(is_l[:, None], le, 0.0)

    em = np.zeros((px.shape[0], 3), np.float64)
    for s in range(spp):
        em += np.asarray(one(jnp.int32(s)), np.float64)
    return em / spp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--ref-spp", type=int, default=512)
    ap.add_argument("--width", type=int, default=12960)
    ap.add_argument("--scenes", default="diffuse,specular,leaf,nested,sds")
    ap.add_argument("--integrators",
                    default="naive,uni,mega,bdpt,bdpt-mega,vcm,vcm-mega,sppm")
    ap.add_argument("--gate", action="store_true",
                    help="assert the GATES mean_ratio thresholds; exit 1 "
                         "on any violation")
    args = ap.parse_args()
    failures = []

    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.utils import rng

    size = args.size
    cam = Camera.pinhole((0.0, 0.0, 1.0), size, size, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(size), jnp.arange(size))
    px, py = px.ravel(), py.ravel()
    key = rng.base_key()
    ref_key = rng.base_key(7)   # independent streams for the reference

    steps = make_steps(size, args.width)
    names = [n for n in args.integrators.split(",") if n in steps]
    scenes = build_scenes(args.scenes.split(","))

    from concurrent.futures import ThreadPoolExecutor

    from cudapathtracer_tpu.utils.host import COMPILE_WORKERS
    pool = ThreadPoolExecutor(max_workers=COMPILE_WORKERS)
    compiled = {
        (sname, iname): pool.submit(
            lambda f=steps[iname], sc=scene: f.lower(
                sc, cam, key, 0, px, py).compile())
        for sname, (scene, refint) in scenes.items()
        for iname in [refint] + [n for n in names if n != refint]}

    def step_for(sname, iname):
        compiled[(sname, iname)].result()  # compile errors raise here
        return steps[iname]

    for sname, (scene, refint) in scenes.items():
        t0 = time.perf_counter()
        ref = render(step_for(sname, refint), scene, cam, ref_key, px, py,
                     args.ref_spp)
        scale = float(np.mean(ref)) or 1.0
        # SPPM-reachable reference: full mean minus directly-visible
        # emission (only meaningful where the reference is uni)
        reachable = None
        if refint == "uni" and "sppm" in names:
            em = visible_emission(scene, cam, ref_key, px, py)
            reachable = max(scale - float(np.mean(em)), 1e-6)
        print(json.dumps({"scene": sname, "reference": refint,
                          "ref_spp": args.ref_spp,
                          "ref_mean": round(scale, 6),
                          **({"reachable_mean": round(reachable, 6)}
                             if reachable else {}),
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        for iname in names:
            t0 = time.perf_counter()
            img = render(step_for(sname, iname), scene, cam, key, px, py,
                         args.spp)
            rel = float(np.sqrt(np.mean((img - ref) ** 2)) / scale)
            ratio = float(np.mean(img)) / scale
            line = {
                "scene": sname, "integrator": iname, "spp": args.spp,
                "rel_rmse": round(rel, 5),
                "mean_ratio": round(ratio, 5),
                "seconds": round(time.perf_counter() - t0, 1)}
            gate_ratio = ratio
            if iname == "sppm" and reachable:
                gate_ratio = float(np.mean(img)) / reachable
                line["ratio_vs_reachable"] = round(gate_ratio, 5)
            bounds = GATES.get((sname, iname))
            if args.gate and bounds:
                lo, hi = bounds
                line["gate"] = [lo, hi]
                if not (lo <= gate_ratio <= hi):
                    line["gate_fail"] = True
                    failures.append((sname, iname, gate_ratio, bounds))
            print(json.dumps(line), flush=True)
    pool.shutdown()
    if args.gate and failures:
        for sname, iname, r, b in failures:
            print(f"GATE FAIL: {sname}/{iname} ratio {r:.4f} "
                  f"outside {b}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
