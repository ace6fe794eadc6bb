#!/usr/bin/env python
"""Decompose an SPPM/VCM energy deficit against the unidirectional truth.

Renders the diffuse Cornell at small size and compares, per stage:
  1. unidirectional reference (high spp)
  2. SPPM via the production hash-grid merge
  3. SPPM via a BRUTE-FORCE all-photon merge (no grid, no cap)
If (3) ~= (1): the estimator is right and the grid query loses photons.
If (3) ~= (2) << (1): the estimator itself (beta / normalization /
deposit set) is wrong.

Usage: JAX_PLATFORMS=cpu python tools/debug_merge.py [--size 32] [--spp 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--ref-spp", type=int, default=64)
    args = ap.parse_args()

    from cudapathtracer_tpu.models import unidirectional, vcm
    from cudapathtracer_tpu.models import common, mis, paths
    from cudapathtracer_tpu.ops import bsdf as bsdf_ops
    from cudapathtracer_tpu.ops import hashgrid, traverse
    from cudapathtracer_tpu.scene import builtin
    from cudapathtracer_tpu.scene.camera import Camera
    from cudapathtracer_tpu.scene.materials import builtin_materials
    from cudapathtracer_tpu.scene.scene import build_scene
    from cudapathtracer_tpu.utils import rng
    from cudapathtracer_tpu.utils.math import (PI, RAY_EPSILON, dot,
                                               length_sq, merge_radius,
                                               normalize, to_local)

    size = args.size
    scene, _ = build_scene(builtin.cornell_with_blocks(), builtin_materials())
    cam = Camera.pinhole((0.0, 0.0, 1.0), size, size, 0.0, 0.0, 0.0, 60.0)
    px, py = jnp.meshgrid(jnp.arange(size), jnp.arange(size))
    px, py = px.ravel(), py.ravel()
    key = rng.base_key()
    rkey = rng.base_key(7)

    # 1. unidirectional reference
    acc = np.zeros((size * size, 3), np.float64)
    for s in range(args.ref_spp):
        li, _ = unidirectional.render_sample(scene, cam, rkey, s, px, py,
                                             max_depth=8)
        acc += np.asarray(li, np.float64)
    ref = acc / args.ref_spp
    ref_mean = float(ref.mean())
    print(f"uni ref mean {ref_mean:.5f}")

    scfg = vcm.VCMConfig(eye_depth=8, light_depth=6, light_trace=False,
                         nee=False, naive=False, connection=False,
                         do_mis=False, do_sppm=True)

    # 2. production SPPM
    acc = np.zeros((size * size, 3), np.float64)
    for s in range(args.spp):
        li, _ = vcm.render_sample(scene, cam, key, s, px, py, cfg=scfg)
        acc += np.asarray(li, np.float64)
    sppm = acc / args.spp
    print(f"sppm grid  mean {float(sppm.mean()):.5f}  "
          f"ratio {float(sppm.mean())/ref_mean:.4f}")

    # 3. brute-force SPPM: one eye bounce to the first non-delta surface,
    # then an O(N*P) merge over every photon
    n = px.shape[0]
    ones = jnp.ones((n,), jnp.float32)
    pid = rng.pixel_ids(px, py)

    @jax.jit
    def brute_sample(sample_idx):
        skey = rng.sample_key(key, sample_idx)
        key_l = jax.random.fold_in(skey, 1)
        key_e = jax.random.fold_in(skey, 2)
        r0 = scene.scene_radius * scfg.r0_multiplier
        mr = merge_radius(r0, jnp.asarray(sample_idx, jnp.float32),
                          scfg.merge_alpha)
        n_paths = n
        eta_vcm = n_paths * PI * mr * mr

        start, _ = paths.start_light_walk(scene, key_l, n, ids=pid)
        first_vm_seed = start.first_vc_scale / jnp.maximum(eta_vcm, 1e-30)
        lbufs, _e, _r = paths.random_walk(
            scene, key_l, start, scfg.light_depth + 1, 1,
            eta_vcm=eta_vcm, first_vm_seed=first_vm_seed, ids=pid)
        pmask = (lbufs.valid & ~lbufs.is_delta).reshape(-1)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        p_pt = flat(lbufs.pt)
        p_wi = flat(lbufs.wo)
        p_beta = flat(lbufs.beta)

        # eye: march to first non-delta surface (diffuse cornell: depth 0)
        estart, _ = paths.start_eye_walk(scene, cam, key_e, px, py, ids=pid)
        o, d = estart.o, estart.d
        hit = traverse.closest_hit(scene, o, d)
        info = traverse.interpolate_hit(scene, o, d, hit)
        normal = info["normal"]
        pos = info["point"]
        mat = scene.materials.gather(info["mat_id"])
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
        conn = hit.valid & ~mat.is_specular
        eye_prev_loc = to_local(normalize(estart.prev_pt - pos), normal)

        merge_norm = 1.0 / (PI * mr * mr * n_paths)

        def fold(colorsum, chunk):
            cp, cw, cb, cm = chunk
            # [C photons] x [N queries]
            d2 = jnp.sum((pos[None, :, :] - cp[:, None, :]) ** 2, axis=-1)
            in_r = cm[:, None] & (d2 <= mr * mr) & conn[None, :]
            wi_loc = to_local(
                jnp.broadcast_to(cw[:, None, :], (cw.shape[0], n, 3)),
                jnp.broadcast_to(normal[None], (cw.shape[0], n, 3)))
            f_val = bsdf_ops.bsdf_f(
                mat, albedo, wi_loc,
                jnp.broadcast_to(eye_prev_loc[None], (cw.shape[0], n, 3)),
                ones, transmission=trans)
            contrib = cb[:, None, :] * f_val * merge_norm
            colorsum = colorsum + jnp.sum(
                jnp.where(in_r[:, :, None], contrib, 0.0), axis=0)
            cnt = jnp.sum(in_r, axis=0)
            return colorsum, cnt

        colorsum = jnp.zeros((n, 3), jnp.float32)
        count = jnp.zeros((n,), jnp.int32)
        C = 512
        P = p_pt.shape[0]
        for c0 in range(0, P, C):
            chunk = (p_pt[c0:c0 + C], p_wi[c0:c0 + C], p_beta[c0:c0 + C],
                     pmask[c0:c0 + C])
            colorsum, cnt = fold(colorsum, chunk)
            count = count + cnt
        return colorsum, count, mr

    # also: count in-range photons found by the production grid path
    @jax.jit
    def grid_count(sample_idx):
        skey = rng.sample_key(key, sample_idx)
        key_l = jax.random.fold_in(skey, 1)
        key_e = jax.random.fold_in(skey, 2)
        r0 = scene.scene_radius * scfg.r0_multiplier
        mr = merge_radius(r0, jnp.asarray(sample_idx, jnp.float32),
                          scfg.merge_alpha)
        eta_vcm = n * PI * mr * mr
        start, _ = paths.start_light_walk(scene, key_l, n, ids=pid)
        first_vm_seed = start.first_vc_scale / jnp.maximum(eta_vcm, 1e-30)
        lbufs, _e, _r = paths.random_walk(
            scene, key_l, start, scfg.light_depth + 1, 1,
            eta_vcm=eta_vcm, first_vm_seed=first_vm_seed, ids=pid)
        pmask = (lbufs.valid & ~lbufs.is_delta).reshape(-1)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        rows = hashgrid.pack_photons(flat(lbufs.pt), flat(lbufs.wo),
                                     flat(lbufs.beta),
                                     flat(lbufs.d_vcm), flat(lbufs.d_vm))
        table = hashgrid.photon_table_size(rows.shape[0])
        grid = hashgrid.build_grid(rows, pmask, scene.node_bounds[0, 0:3],
                                   mr, table)
        estart, _ = paths.start_eye_walk(scene, cam, key_e, px, py, ids=pid)
        hit = traverse.closest_hit(scene, estart.o, estart.d)
        info = traverse.interpolate_hit(scene, estart.o, estart.d, hit)
        mat = scene.materials.gather(info["mat_id"])
        conn = hit.valid & ~mat.is_specular

        def fold(cnt, row, in_range, w):
            return cnt + in_range.astype(jnp.int32)

        cnt = hashgrid.fold_neighbors(grid, info["point"], mr, 64, fold,
                                      jnp.zeros((n,), jnp.int32),
                                      active=conn)
        return cnt

    acc = np.zeros((size * size, 3), np.float64)
    cnt_tot = np.zeros((size * size,), np.float64)
    gcnt_tot = np.zeros((size * size,), np.float64)
    for s in range(args.spp):
        li, cnt, mr = brute_sample(s)
        acc += np.asarray(li, np.float64)
        cnt_tot += np.asarray(cnt, np.float64)
        gcnt_tot += np.asarray(grid_count(s), np.float64)
    brute = acc / args.spp
    print(f"sppm brute mean {float(brute.mean()):.5f}  "
          f"ratio {float(brute.mean())/ref_mean:.4f}")
    print(f"avg in-range photons/query: brute {cnt_tot.mean()/args.spp:.2f} "
          f"grid {gcnt_tot.mean()/args.spp:.2f}  (r={float(mr):.4f})")


if __name__ == "__main__":
    main()
