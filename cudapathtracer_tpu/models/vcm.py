"""Vertex Connection and Merging (+ SPPM as flag-restricted VCM).

Wavefront re-design of the reference VCM (deviceCode.cu:1958-3496):
  1. light pass — VCM light walk (models/paths.py with the eta_vcm-extended
     d_vcm/d_vc/d_vm recursion) that also deposits photons at every
     non-delta vertex, plus the t=1 light-trace splat with the eta_vcm MIS
     term (scatter-add instead of atomicAdd)
  2. photon grid build — sort-based (ops/hashgrid.py) instead of
     CUB radix sort + open hash table
  3. eye pass — on-the-fly eye walk (no stored eye path, mirroring the
     reference's VRAM-saving choice, deviceCode.cu:2861) with per-bounce
     connections (s=0 implicit, s=1 NEE, s>=2 vs the stored light path) and
     the photon-merge estimator beta_p * f * beta_e / (pi r^2 n_paths)

SPPM = connections/NEE/naive/light-trace/MIS off, merge on, break after the
first non-delta merge surface (main.cu:325-333, deviceCode.cu:3046).

Faithfully kept reference quirks (cited): connectNEE's squared bsdfRatio in
wLight (deviceCode.cu:2533 — unlike BDPT's linear ratio), the eta-less
implicit-hit weight (2436-2446), per-connection firefly clamping of the
*weighted* contribution (2955-2960). Deviations: merge-side local directions
are normalized before BSDF/pdf evaluation (the reference feeds unnormalized
vectors, deviceCode.cu:3003-3014, which distorts GGX evaluation; identical
for Lambertian surfaces), and neighborhood queries use bounded 8-cell/2r
lookups (ops/hashgrid.py) instead of unbounded 27-cell scans.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.models import common, mis, paths
from cudapathtracer_tpu.models.bdpt import (MAX_G_CONNECT, _bdpt_nee,
                                            _plane_area, _weighted)
from cudapathtracer_tpu.ops import bsdf as bsdf_ops
from cudapathtracer_tpu.ops import hashgrid, traverse
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import (EPSILON, MAX_FIREFLY_LUM, PI,
                                           RAY_EPSILON, dot, length_sq,
                                           luminance, merge_radius, normalize,
                                           to_local, to_world)


@dataclass(frozen=True)
class VCMConfig:
    eye_depth: int = 16
    light_depth: int = 10
    light_trace: bool = True
    nee: bool = True
    naive: bool = True
    connection: bool = True
    do_mis: bool = True
    do_merge: bool = True
    do_sppm: bool = False
    paint_weight: bool = False
    merge_alpha: float = 0.7           # "VCM Merge Radius Power Factor"
    r0_multiplier: float = 0.01        # "VCM Initial Merge Radius Multiplier"
    max_per_cell: int = 8              # bounded-gather cap (see module doc)
    sample_environment: bool = False   # escape -> sky, weight 1 (bdpt.py doc)

    @staticmethod
    def from_config(cfg) -> "VCMConfig":
        return VCMConfig(
            eye_depth=max(cfg.bdpt_eye_depth, 1),
            light_depth=max(cfg.bdpt_light_depth, 1),
            light_trace=cfg.bdpt_light_trace, nee=cfg.bdpt_nee,
            naive=cfg.bdpt_naive, connection=cfg.bdpt_connection,
            do_mis=cfg.bdpt_do_mis, do_merge=cfg.vcm_do_merge,
            do_sppm=cfg.do_sppm, paint_weight=cfg.bdpt_paint_weight,
            merge_alpha=cfg.vcm_merge_const or 0.7,
            r0_multiplier=cfg.vcm_initial_merge_radius_multiplier or 0.01,
            max_per_cell=max(int(getattr(cfg, "vcm_max_per_cell", 8)), 1),
            sample_environment=cfg.sample_environment)


def _clamp_firefly(c):
    lum = luminance(c)
    scale = jnp.where(lum > MAX_FIREFLY_LUM,
                      MAX_FIREFLY_LUM / jnp.maximum(lum, 1e-20), 1.0)
    return c * scale[:, None]


def vcm_light_splat(scene, camera, lbufs, cfg, eta_vcm, fb):
    """t=1 splat over stored VCM light vertices (deviceCode.cu:2266-2382).
    Unlike BDPT, the light endpoint itself is not stored/splatted. fb may
    be larger than the path count n (full-image buffer under tile
    sharding); splat pixel indices are global raster indices."""
    n = lbufs.valid.shape[1]
    w, h = camera.width, camera.height
    plane_area = _plane_area(camera)
    ones = jnp.ones((n,), jnp.float32)

    def body(carry, j):
        fb, rays = carry
        pick = lambda a: jax.lax.dynamic_index_in_dim(a, j, axis=0,
                                                      keepdims=False)
        valid, is_delta = pick(lbufs.valid), pick(lbufs.is_delta)
        pt, nrm = pick(lbufs.pt), pick(lbufs.n)
        go = valid & ~is_delta
        rx, ry, on_screen = camera.world_to_raster(pt)
        go = go & on_screen

        to_cam = camera.origin - pt
        dist = jnp.sqrt(jnp.maximum(length_sq(to_cam), 1e-20))
        tcu = to_cam / dist[:, None]
        rays = rays + jnp.sum(go.astype(jnp.int32))
        shadow = traverse.shadow_factor(scene, pt + nrm * RAY_EPSILON, tcu,
                                        dist - RAY_EPSILON, active=go)
        clear = jnp.max(shadow, axis=-1) > 0.0
        cos_l = dot(nrm, tcu)
        cos_c = jnp.abs(dot(jnp.broadcast_to(camera.forward, tcu.shape), -tcu))
        go = go & clear & (cos_l > EPSILON)

        to_cam_local = to_local(tcu, nrm)
        to_prev_local = to_local(pick(lbufs.wo), nrm)
        mat = scene.materials.gather(pick(lbufs.mat_id))
        albedo = bsdf_ops.resolve_albedo(scene, mat, pick(lbufs.uv))
        trans = bsdf_ops.resolve_transmission(scene, mat, pick(lbufs.uv))
        light_f = bsdf_ops.bsdf_f(mat, albedo, to_prev_local, to_cam_local,
                                  ones, transmission=trans)

        d2 = jnp.maximum(length_sq(to_cam), RAY_EPSILON)
        we = 1.0 / (plane_area * cos_c ** 4)
        g = cos_l * cos_c / d2
        contrib = pick(lbufs.beta) * light_f * (g * we)[:, None] * shadow

        pdf_curr_rev_area = cos_l / (d2 * plane_area * cos_c ** 3)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, to_cam_local, to_prev_local,
                                       ones, transmission=trans)
        w_light = pdf_curr_rev_area * (eta_vcm + pick(lbufs.d_vcm)
                                       + pdf_rev_sa * pick(lbufs.d_vc))
        weight = 1.0 / (1.0 + w_light)

        out = jnp.where(go[:, None], _weighted(contrib, weight, cfg), 0.0)
        pix = (jnp.clip(ry.astype(jnp.int32), 0, h - 1) * w
               + jnp.clip(rx.astype(jnp.int32), 0, w - 1))
        return (fb.at[pix].add(out, mode="drop"), rays), None

    (fb, rays), _ = jax.lax.scan(body, (fb, jnp.int32(0)),
                                 jnp.arange(cfg.light_depth))
    return fb, rays


@partial(jax.jit, static_argnames=("cfg", "splat_shape",
                                   "count_merge_dropped", "photon_axis"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: VCMConfig, splat_shape: int | None = None,
                  count_merge_dropped: bool = False,
                  photon_axis: str | None = None):
    """One progressive VCM/SPPM sample -> (radiance [N,3], rays); with
    splat_shape set, (li_local [N,3], splat [splat_shape,3], rays) for
    tile sharding (see models/bdpt.py render_sample).

    count_merge_dropped appends a scalar i32 counter to the outputs: the
    number of candidate photons the static max_per_cell cap truncated out
    of the merge this sample (upper bound on in-range photons silently
    dropped — the reference visits every photon in a cell unboundedly,
    deviceCode.cu:2968-3048). The driver surfaces it so the cap is chosen
    from data instead of silence.

    photon_axis (tile-sharded VCM with merging; SURVEY §5.8 "all-gather for
    photon maps if the light pass is sharded"): the name of the shard_map
    mesh axis the pixel block is sharded over. Each shard's packed 32-B
    photon rows are all-gathered over that axis (tiled, so the union lands
    in global pixel order), the hash grid is built per shard on the UNION,
    and eta_vcm / the merge normalization use the GLOBAL path count — the
    sharded equivalent of the reference's single shared photon grid
    every thread reads (deviceCode.cu:3359). Only valid inside shard_map;
    combine with splat_shape for the light-trace splat."""
    n = px.shape[0]
    skey = rng.sample_key(base_key, sample_idx)
    key_l = jax.random.fold_in(skey, 1)
    key_e = jax.random.fold_in(skey, 2)
    ones = jnp.ones((n,), jnp.float32)
    num_lights = max(scene.num_lights, 1)
    pid = rng.pixel_ids(px, py)

    # progressive merge radius (util.cuh:415-418; r0 = sceneRadius * mult,
    # deviceCode.cu:3328)
    r0 = scene.scene_radius * cfg.r0_multiplier
    mr = merge_radius(r0, jnp.asarray(sample_idx, jnp.float32),
                      cfg.merge_alpha)
    # the estimator is normalized by the TOTAL light-path count: under
    # photon_axis sharding that is n per shard times the axis size
    n_paths = n * (jax.lax.psum(1, photon_axis) if photon_axis else 1)
    eta_vcm = n_paths * PI * mr * mr

    # ---- light pass ----
    start, lv0 = paths.start_light_walk(scene, key_l, n, ids=pid)
    first_vm_seed = start.first_vc_scale / jnp.maximum(eta_vcm, 1e-30)
    lbufs, _lesc, lrays = paths.random_walk(
        scene, key_l, start, cfg.light_depth + 1, 1,  # TRANSPORT_IMPORTANCE
        eta_vcm=eta_vcm, first_vm_seed=first_vm_seed, ids=pid)

    fb = jnp.zeros((splat_shape or n, 3), jnp.float32)
    rays_s = jnp.int32(0)
    if cfg.light_trace:
        fb, rays_s = vcm_light_splat(scene, camera, lbufs, cfg, eta_vcm, fb)

    # ---- photon grid ----
    grid = None
    if cfg.do_merge:
        pmask = (lbufs.valid & ~lbufs.is_delta).reshape(-1)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        rows = hashgrid.pack_photons(flat(lbufs.pt), flat(lbufs.wo),
                                     flat(lbufs.beta),
                                     flat(lbufs.d_vcm), flat(lbufs.d_vm))
        if photon_axis:
            # photon exchange across devices: the packed rows are small
            # (light_depth+1 per path x 32 B), so a tiled all-gather of
            # rows + validity builds every shard the same global grid
            rows = jax.lax.all_gather(rows, photon_axis, axis=0,
                                      tiled=True)
            pmask = jax.lax.all_gather(pmask, photon_axis, axis=0,
                                       tiled=True)
        table = hashgrid.photon_table_size(rows.shape[0])
        # per-sample salt randomizes within-bucket order so the merge
        # cap's reweighted subsample is unbiased (hashgrid module doc)
        salt = (jnp.asarray(sample_idx, jnp.uint32)
                * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
        grid = hashgrid.build_grid(rows, pmask, scene.node_bounds[0, 0:3],
                                   mr, table, salt=salt)

    # ---- eye pass (on-the-fly walk + per-bounce connections/merge) ----
    estart, _ = paths.start_eye_walk(scene, camera, key_e, px, py, ids=pid)

    def body(carry, depth):
        (o, d, thr, prev_pdf_sa, prev_cos, prev_pt, mstate, alive, prev_delta,
         colorsum, rays, dropped) = carry
        bkey = rng.bounce_key(key_e, depth)
        rays = rays + jnp.sum(alive.astype(jnp.int32))

        hit = traverse.closest_hit(scene, o, d, active=alive)
        info = traverse.interpolate_hit(scene, o, d, hit)
        reached = alive & hit.valid
        if cfg.sample_environment:
            # escape -> sky, MIS weight 1 (models/bdpt.py module doc)
            missed = alive & ~hit.valid
            out = _weighted(thr * common.sample_sky(d, True),
                            jnp.ones((n,), jnp.float32), cfg)
            colorsum = colorsum + jnp.where(missed[:, None], out, 0.0)

        normal = info["normal"]
        pos = info["point"]
        wo_local = to_local(d, normal)
        mat = scene.materials.gather(info["mat_id"])
        albedo = bsdf_ops.resolve_albedo(scene, mat, info["uv"])
        trans = bsdf_ops.resolve_transmission(scene, mat, info["uv"])
        cur_delta = mat.is_specular

        d2p = jnp.maximum(length_sq(pos - prev_pt), RAY_EPSILON)
        pdf_fwd_area = prev_pdf_sa * jnp.abs(wo_local[..., 2]) / d2p
        g = prev_cos / d2p

        wi_local, f_val, pdf_sa = bsdf_ops.bsdf_sample(
            bkey, 0, mat, albedo, -wo_local, info["backface"], ones, 0,
            ids=pid, transmission=trans)
        pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, wi_local, -wo_local, ones,
                                       transmission=trans)
        valid = reached & (pdf_sa >= EPSILON)

        first_d_vcm = 1.0 / jnp.maximum(pdf_fwd_area, 1e-20)
        d_vcm, d_vc, d_vm, mstate2 = mis.advance(
            mstate, depth == 0, pdf_fwd_area, g, pdf_rev_sa, cur_delta,
            first_d_vcm, jnp.zeros((n,)), jnp.zeros((n,)), eta_vcm)

        conn = valid & ~cur_delta
        ev = dict(pt=pos, n=normal, uv=info["uv"])
        prev_to_curr = pos - prev_pt
        prev_to_curr_local = to_local(prev_to_curr, normal)

        # ---- s = 0: implicit hit (connectImplicitHit, deviceCode.cu:2389)
        if cfg.naive:
            is_light = conn & (info["light_ind"] >= 0) & ~info["backface"]
            lidx = jnp.maximum(info["light_ind"], 0)
            le = scene.light_emission[lidx]
            area = scene.light_area[lidx]
            cos_l = dot(normal, normalize(prev_pt - pos))
            pdf_connect = jnp.where(prev_delta, 0.0,
                                    (1.0 / num_lights)
                                    / jnp.maximum(area, 1e-20))
            # NOTE: no eta_vcm term here (reference quirk, 2436-2446)
            w_eye = pdf_connect * d_vcm + pdf_connect * (cos_l / PI) * d_vc
            weight = 1.0 / (1.0 + w_eye)
            out = _weighted(le * thr, weight, cfg)
            # Deliberate deviation, mirrored on the BDPT t==2 exemption
            # (models/bdpt.py first_t): directly-visible emission is NOT a
            # firefly — the reference's unconditional clamp at
            # deviceCode.cu:2953 squashes Le luminance to MAX_FIREFLY_LUM
            # on light pixels (a visible loss of image mean on the diffuse
            # Cornell, tools/debug_vcm_split.py); depth 0 is exempt here.
            out = jnp.where(depth == 0, out, _clamp_firefly(out))
            colorsum = colorsum + jnp.where(is_light[:, None], out, 0.0)

        # ---- s = 1: NEE (connectNEE, deviceCode.cu:2460-2549)
        if cfg.nee and scene.num_lights > 0:
            rays = rays + jnp.sum(conn.astype(jnp.int32))
            ne = _bdpt_nee(scene, bkey, 7, ev, mat, albedo,
                           prev_to_curr_local, conn, ids=pid, trans_e=trans)
            pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat, -prev_to_curr_local,
                                            ne["stl_local"], ones,
                                            transmission=trans)
            pdf_bsdf_area = pdf_bsdf_sa * jnp.abs(ne["cos_light"]) / ne["d2"]
            ratio = pdf_bsdf_area / jnp.maximum(ne["pdf_connect"], 1e-20)
            w_light = ratio * ratio  # reference quirk: squared (2533)
            pdf_curr_rev_area = (ne["pdf_emit_sa"]
                                 * jnp.abs(ne["stl_local"][..., 2]) / ne["d2"])
            pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat, ne["stl_local"],
                                                -prev_to_curr_local, ones,
                                                transmission=trans)
            w_eye = pdf_curr_rev_area * (eta_vcm + d_vcm
                                         + pdf_prev_rev_sa * d_vc)
            weight = 1.0 / (1.0 + w_light + w_eye)
            out = _weighted(ne["contrib"] * thr, weight, cfg)
            out = _clamp_firefly(out)
            colorsum = colorsum + jnp.where((conn & ne["ok"])[:, None], out,
                                            0.0)

        # ---- s >= 2: connections vs stored light path (connectGeneral),
        # scanned over the light path (compile O(1) in light_depth)
        if cfg.connection:
            def connect_one(carry, j):
                colorsum, rays = carry
                pick = lambda a: jax.lax.dynamic_index_in_dim(
                    a, j, axis=0, keepdims=False)
                do = (conn & pick(lbufs.valid) & ~pick(lbufs.is_delta))
                lpt, lnrm = pick(lbufs.pt), pick(lbufs.n)
                e2l = lpt - pos
                d2 = jnp.maximum(length_sq(e2l), RAY_EPSILON)
                dist = jnp.sqrt(d2)
                e2l_u = e2l / dist[:, None]
                cos_l = jnp.abs(dot(lnrm, -e2l_u))
                cos_e = jnp.abs(dot(normal, e2l_u))
                do = do & (cos_l >= EPSILON) & (cos_e >= EPSILON)

                rays = rays + jnp.sum(do.astype(jnp.int32))
                shadow = traverse.shadow_factor(
                    scene, pos + normal * RAY_EPSILON, e2l_u,
                    dist - RAY_EPSILON, active=do)
                do = do & (jnp.max(shadow, axis=-1) > 0.0)

                mat_l = scene.materials.gather(pick(lbufs.mat_id))
                albedo_l = bsdf_ops.resolve_albedo(scene, mat_l,
                                                   pick(lbufs.uv))
                trans_l = bsdf_ops.resolve_transmission(scene, mat_l,
                                                        pick(lbufs.uv))
                l2e_loc_l = to_local(-e2l_u, lnrm)
                to_l_from_prev_loc = to_local(-pick(lbufs.wo), lnrm)
                l2e_loc_e = to_local(-e2l_u, normal)
                to_prev_loc_e = to_local(normalize(prev_pt - pos), normal)

                pdf_eye_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_l, -to_l_from_prev_loc, l2e_loc_l, ones,
                    transmission=trans_l)
                pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2
                pdf_bef_eye_rev_sa = bsdf_ops.bsdf_pdf(
                    mat, -l2e_loc_e, to_prev_loc_e, ones,
                    transmission=trans)
                pdf_light_rev_sa = bsdf_ops.bsdf_pdf(
                    mat, to_prev_loc_e, -l2e_loc_e, ones,
                    transmission=trans)
                pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2
                pdf_bef_light_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_l, l2e_loc_l, -to_l_from_prev_loc, ones,
                    transmission=trans_l)

                w_eye = pdf_eye_rev_area * (eta_vcm + d_vcm
                                            + pdf_bef_eye_rev_sa * d_vc)
                w_light = pdf_light_rev_area * (
                    eta_vcm + pick(lbufs.d_vcm)
                    + pdf_bef_light_rev_sa * pick(lbufs.d_vc))
                weight = 1.0 / (1.0 + w_eye + w_light)

                f_eye = bsdf_ops.bsdf_f(mat, albedo, -l2e_loc_e,
                                        to_prev_loc_e, ones,
                                        transmission=trans)
                f_light = bsdf_ops.bsdf_f(mat_l, albedo_l, l2e_loc_l,
                                          -to_l_from_prev_loc, ones,
                                          transmission=trans_l)
                gg = jnp.minimum(cos_e * cos_l / d2, MAX_G_CONNECT)
                contrib = (thr * pick(lbufs.beta) * f_eye * f_light
                           * gg[:, None] * shadow)
                out = _clamp_firefly(_weighted(contrib, weight, cfg))
                colorsum = colorsum + jnp.where(do[:, None], out, 0.0)
                return (colorsum, rays), None

            (colorsum, rays), _ = jax.lax.scan(
                connect_one, (colorsum, rays), jnp.arange(cfg.light_depth))

        # ---- merge (deviceCode.cu:2968-3048) — folded over the neighborhood
        if cfg.do_merge:
            merge_norm = 1.0 / (PI * mr * mr * n_paths)
            eye_prev_loc = to_local(normalize(prev_pt - pos), normal)

            def merge_fold(colorsum, row, in_range, w_cell):
                # wi points toward the photon's prev vertex; w_cell is
                # the cap-reweighting factor (hashgrid._cell_weight)
                _, photon_wi, p_beta, p_d_vcm, p_d_vm = \
                    hashgrid.photon_fields(row)
                wi_loc = to_local(photon_wi, normal)
                f_val = bsdf_ops.bsdf_f(mat, albedo, wi_loc, eye_prev_loc,
                                        ones, transmission=trans)
                pdf_eye_rev = bsdf_ops.bsdf_pdf(mat, wi_loc, eye_prev_loc,
                                                ones, transmission=trans)
                pdf_light_rev = bsdf_ops.bsdf_pdf(mat, eye_prev_loc, wi_loc,
                                                  ones, transmission=trans)
                w_eye = d_vcm / jnp.maximum(eta_vcm, 1e-30) \
                    + pdf_eye_rev * d_vm
                w_light = p_d_vcm / jnp.maximum(eta_vcm, 1e-30) \
                    + pdf_light_rev * p_d_vm
                weight = 1.0 / (1.0 + w_eye + w_light)
                contrib = (p_beta * f_val * thr * merge_norm
                           * w_cell[:, None])
                out = _weighted(contrib, weight, cfg)
                return colorsum + jnp.where(in_range[:, None], out, 0.0)

            if count_merge_dropped:
                colorsum, drop_b = hashgrid.fold_neighbors(
                    grid, pos, mr, cfg.max_per_cell, merge_fold, colorsum,
                    active=conn, count_dropped=True)
                dropped = dropped + drop_b
            else:
                colorsum = hashgrid.fold_neighbors(
                    grid, pos, mr, cfg.max_per_cell, merge_fold, colorsum,
                    active=conn)

        # ---- continue the walk / SPPM first-surface break
        new_thr = thr * f_val * (jnp.abs(wi_local[..., 2])
                                 / jnp.maximum(pdf_sa, 1e-20))[:, None]
        wi_world = normalize(to_world(wi_local, normal))
        transmitting = dot(wi_world, normal) < 0.0
        side = jnp.where(transmitting, -1.0, 1.0)
        new_o = pos + normal * (side * RAY_EPSILON)[:, None]

        keep = valid
        if cfg.do_sppm and cfg.do_merge:
            keep = keep & cur_delta  # break after first non-delta surface

        upd = valid[:, None]
        carry2 = (jnp.where(upd, new_o, o), jnp.where(upd, wi_world, d),
                  jnp.where(upd, new_thr, thr),
                  jnp.where(valid, pdf_sa, prev_pdf_sa),
                  jnp.where(valid, jnp.abs(wi_local[..., 2]), prev_cos),
                  jnp.where(upd, pos, prev_pt),
                  jax.tree.map(lambda a2, a1: jnp.where(valid, a2, a1),
                               mstate2, mstate),
                  keep, jnp.where(reached, cur_delta, prev_delta),
                  colorsum, rays, dropped)
        return carry2, None

    carry0 = (estart.o, estart.d, estart.throughput, estart.prev_pdf_sa,
              estart.prev_cos, estart.prev_pt, mis.MisState.zeros(n),
              jnp.ones((n,), bool), jnp.ones((n,), bool),
              jnp.zeros((n, 3), jnp.float32), jnp.int32(0), jnp.int32(0))
    carry, _ = jax.lax.scan(body, carry0, jnp.arange(cfg.eye_depth))
    colorsum, erays, dropped = carry[-3], carry[-2], carry[-1]

    rays = lrays + rays_s + erays
    out = ((colorsum, fb, rays) if splat_shape is not None
           else (colorsum + fb, rays))
    if count_merge_dropped:
        return out + (dropped,)
    return out
