"""Bidirectional path tracer with O(1) recursive MIS.

Wavefront re-design of the reference BDPT (deviceCode.cu:622-1956): a light
pass (light-path walk + t=1 light-trace splat via scatter-add instead of
atomicAdd), an eye pass, and a connection stage over all static (t, s)
pairs. Because the path buffers are depth-major (models/paths.py), every
vertex access in the connection loops is a static slice; per-(t,s) work is a
masked shadow traversal + pure elementwise math.

Strategy toggles / MIS / weight-painting mirror the reference's constant
flags (deviceCode.cu:9-51): BDPT_LIGHTTRACE, BDPT_NEE, BDPT_NAIVE,
BDPT_CONNECTION, BDPT_DOMIS, BDPT_PAINTWEIGHT — here static jit config.
Environment (sky): the reference leaves its BDPT env branches unimplemented
(deviceCode.cu:1541, 1558); this framework EXCEEDS that behind
SAMPLE_ENVIRONMENT — an eye walk that escapes the scene picks up the sky
radiance with MIS weight 1 (the sky is reachable only by escaping: no env
NEE, no env light-path endpoints, so no competing strategy exists).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.models import common, paths
from cudapathtracer_tpu.ops import bsdf as bsdf_ops
from cudapathtracer_tpu.ops import traverse
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import (EPSILON, MAX_FIREFLY_LUM, PI,
                                           RAY_EPSILON, dot, length_sq,
                                           luminance, normalize, to_local)

MAX_G_NEE = 15.0      # deviceCode.cu:683
MAX_G_CONNECT = 2.0   # deviceCode.cu:1753


@dataclass(frozen=True)
class BDPTConfig:
    eye_depth: int = 16
    light_depth: int = 10
    light_trace: bool = True
    nee: bool = True
    naive: bool = True
    connection: bool = True
    do_mis: bool = True
    paint_weight: bool = False
    sample_environment: bool = False

    @staticmethod
    def from_config(cfg) -> "BDPTConfig":
        return BDPTConfig(
            eye_depth=max(cfg.bdpt_eye_depth, 2),
            light_depth=max(cfg.bdpt_light_depth, 1),
            light_trace=cfg.bdpt_light_trace, nee=cfg.bdpt_nee,
            naive=cfg.bdpt_naive, connection=cfg.bdpt_connection,
            do_mis=cfg.bdpt_do_mis, paint_weight=cfg.bdpt_paint_weight,
            sample_environment=cfg.sample_environment)


def _weighted(contrib, weight, cfg: BDPTConfig):
    if cfg.paint_weight:
        return jnp.broadcast_to(weight[:, None], contrib.shape)
    if cfg.do_mis:
        return contrib * weight[:, None]
    return contrib


def _plane_area(camera):
    aspect = camera.width / camera.height
    return 4.0 * aspect * camera.fov_scale * camera.fov_scale


def _lv(bufs: paths.PathBuffers, v0: dict, s: int):
    """Light vertex s (1-based vertex count; s=1 is the endpoint itself)."""
    if s == 1:
        n = v0["pt"].shape[0]
        return dict(pt=v0["pt"], n=v0["n"], beta=v0["beta"],
                    wo=jnp.zeros_like(v0["pt"]), uv=jnp.zeros((n, 2)),
                    d_vcm=jnp.zeros((n,)), d_vc=jnp.zeros((n,)),
                    is_delta=jnp.zeros((n,), bool),
                    mat_id=v0["mat_id"], pdf_fwd=v0["pdf_fwd"],
                    tri=v0["tri"], valid=jnp.ones((n,), bool))
    j = s - 2
    return dict(pt=bufs.pt[j], n=bufs.n[j], beta=bufs.beta[j], wo=bufs.wo[j],
                uv=bufs.uv[j], d_vcm=bufs.d_vcm[j], d_vc=bufs.d_vc[j],
                is_delta=bufs.is_delta[j], mat_id=bufs.mat_id[j],
                pdf_fwd=bufs.pdf_fwd[j], tri=None, valid=bufs.valid[j])


def light_trace_splat(scene, camera, lbufs, lv0, cfg: BDPTConfig, fb,
                      active=None):
    """t=1 strategy: connect every light vertex to the camera lens and splat
    (lightPathTracing, deviceCode.cu:1290-1432). Scatter-add replaces
    atomicAdd. s=1 (the light endpoint) is a special static case; s>=2 is a
    lax.scan over the stored vertices (compile O(1) in light_depth).
    `active` masks whole light paths (the mega engines' chunk-tail
    padding). Returns (fb, rays)."""
    n = lv0["pt"].shape[0]
    w, h = camera.width, camera.height
    plane_area = _plane_area(camera)
    ones = jnp.ones((n,), jnp.float32)
    rays = jnp.int32(0)
    if active is None:
        active = jnp.ones((n,), bool)

    def splat_vertex(fb, rays, v, first: bool):
        rx, ry, on_screen = camera.world_to_raster(v["pt"])
        go = v["valid"] & on_screen & ~v["is_delta"] & active

        to_cam = camera.origin - v["pt"]
        dist = jnp.sqrt(jnp.maximum(length_sq(to_cam), 1e-20))
        to_cam_u = to_cam / dist[:, None]
        origin = v["pt"] + v["n"] * RAY_EPSILON
        rays = rays + jnp.sum(go.astype(jnp.int32))
        shadow = traverse.shadow_factor(scene, origin, to_cam_u,
                                        dist - RAY_EPSILON, active=go)
        clear = jnp.max(shadow, axis=-1) > 0.0

        cos_light = dot(v["n"], to_cam_u)          # signed (deviceCode.cu:1339)
        cos_cam = jnp.abs(dot(jnp.broadcast_to(camera.forward,
                                               to_cam_u.shape), -to_cam_u))
        go = go & clear & (cos_light > EPSILON)

        to_cam_local = to_local(to_cam_u, v["n"])
        d2 = jnp.maximum(length_sq(to_cam), RAY_EPSILON)
        pdf_trace_cam = cos_light / (d2 * plane_area * cos_cam ** 3)
        if first:
            light_f = jnp.full((n, 3), 1.0 / PI)   # beta0 carries Le*pi
            w_light = pdf_trace_cam / jnp.maximum(v["pdf_fwd"], 1e-20)
        else:
            to_prev_local = to_local(v["wo"], v["n"])
            mat = scene.materials.gather(v["mat_id"])
            albedo = bsdf_ops.resolve_albedo(scene, mat, v["uv"])
            trans = bsdf_ops.resolve_transmission(scene, mat, v["uv"])
            # f_eval(-currToPrev_local, toCamera_local) (deviceCode.cu:1363)
            light_f = bsdf_ops.bsdf_f(mat, albedo, to_prev_local,
                                      to_cam_local, ones, transmission=trans)
            pdf_rev_sa = bsdf_ops.bsdf_pdf(mat, to_cam_local, to_prev_local,
                                           ones, transmission=trans)
            w_light = pdf_trace_cam * (v["d_vcm"] + pdf_rev_sa * v["d_vc"])

        we = 1.0 / (plane_area * cos_cam ** 4)
        g = cos_light * cos_cam / d2
        contrib = v["beta"] * light_f * (g * we)[:, None] * shadow
        weight = 1.0 / (1.0 + w_light)

        out = jnp.where(go[:, None], _weighted(contrib, weight, cfg), 0.0)
        pix = (jnp.clip(ry.astype(jnp.int32), 0, h - 1) * w
               + jnp.clip(rx.astype(jnp.int32), 0, w - 1))
        return fb.at[pix].add(out, mode="drop"), rays

    fb, rays = splat_vertex(fb, rays, _lv(lbufs, lv0, 1), True)

    if cfg.light_depth >= 2:
        def body(carry, j):
            fb, rays = carry
            pick = lambda a: jax.lax.dynamic_index_in_dim(
                a, j, axis=0, keepdims=False)
            v = dict(pt=pick(lbufs.pt), n=pick(lbufs.n), wo=pick(lbufs.wo),
                     uv=pick(lbufs.uv), beta=pick(lbufs.beta),
                     pdf_fwd=pick(lbufs.pdf_fwd), d_vcm=pick(lbufs.d_vcm),
                     d_vc=pick(lbufs.d_vc), is_delta=pick(lbufs.is_delta),
                     mat_id=pick(lbufs.mat_id), valid=pick(lbufs.valid))
            fb, rays = splat_vertex(fb, rays, v, False)
            return (fb, rays), None

        (fb, rays), _ = jax.lax.scan(body, (fb, rays),
                                     jnp.arange(cfg.light_depth - 1))
    return fb, rays


def _bdpt_nee(scene, key, tag, ev, mat_e, albedo_e, prev_to_curr_local,
              active, ids=None, trans_e=None):
    """BDPTnextEventEstimation (deviceCode.cu:622-748): area-measure light
    pdf, interpolated light normal, G clamp, shadow with the light triangle
    excluded. Returns dict of the quantities the s=1 weight needs."""
    n = ev["pt"].shape[0]
    num = max(scene.num_lights, 1)
    kk = jax.random.fold_in(key, tag)
    ul = rng.uniform_any(kk, 0, n, ids)
    li = jnp.minimum((ul * num).astype(jnp.int32), num - 1)
    a, b, c = scene.light_p0[li], scene.light_p1[li], scene.light_p2[li]
    tri = scene.light_tri[li]
    n3 = scene.tri_n[tri]
    u = jnp.sqrt(rng.uniform_any(kk, 1, n, ids))
    v = rng.uniform_any(kk, 2, n, ids)
    w0, w1, w2 = 1.0 - u, u * (1.0 - v), u * v
    p = w0[:, None] * a + w1[:, None] * b + w2[:, None] * c
    lnrm = normalize(w0[:, None] * n3[:, 0] + w1[:, None] * n3[:, 1]
                     + w2[:, None] * n3[:, 2])

    stl = p - ev["pt"]
    d2 = jnp.maximum(length_sq(stl), RAY_EPSILON)
    dist = jnp.sqrt(d2)
    stl_u = stl / dist[:, None]

    origin = ev["pt"] + ev["n"] * RAY_EPSILON
    shadow = traverse.shadow_factor(scene, origin, stl_u, dist - EPSILON,
                                    skip_tri=tri, active=active)
    clear = jnp.max(shadow, axis=-1) > 0.0

    cos_light = dot(lnrm, -stl_u)
    cos_surf = jnp.abs(dot(ev["n"], stl_u))
    g = jnp.minimum(cos_light * cos_surf / d2, MAX_G_NEE)

    area = scene.light_area[li]
    pdf_connect = (1.0 / num) / jnp.maximum(area, 1e-20)  # area measure
    pdf_emit_sa = cos_light / PI

    stl_local = to_local(stl_u, ev["n"])
    f_val = bsdf_ops.bsdf_f(mat_e, albedo_e, -prev_to_curr_local, stl_local,
                            jnp.ones((n,)), transmission=trans_e)
    le = scene.light_emission[li]
    contrib = shadow * f_val * le * (g / pdf_connect)[:, None]

    ok = active & clear & (cos_light >= EPSILON)
    return dict(ok=ok, contrib=contrib, pdf_connect=pdf_connect,
                pdf_emit_sa=pdf_emit_sa, cos_light=cos_light, d2=d2,
                stl_local=stl_local)


@partial(jax.jit, static_argnames=("cfg", "splat_shape"))
def render_sample(scene, camera, base_key, sample_idx, px, py, *,
                  cfg: BDPTConfig, splat_shape: int | None = None):
    """One progressive BDPT sample. Returns (radiance [N,3] — includes the
    scatter-add light-trace splat over the whole image, rays [scalar]).

    splat_shape: when set (tile sharding, parallel/sharding.py), the
    light-trace splat buffer covers the FULL image (splat_shape = W*H
    pixels) and is returned separately as (li_local [N,3],
    splat [splat_shape,3], rays) — the caller psums the splat over the
    tile axis. Splat pixel indices are global raster indices either way
    (lightPathTracing's atomicAdd targets, deviceCode.cu:1426-1428)."""
    n = px.shape[0]
    skey = rng.sample_key(base_key, sample_idx)
    key_l = jax.random.fold_in(skey, 1)
    key_e = jax.random.fold_in(skey, 2)
    key_c = jax.random.fold_in(skey, 3)
    ones = jnp.ones((n,), jnp.float32)
    pid = rng.pixel_ids(px, py)

    # --- light pass (vertices 0..light_depth-1, s up to light_depth) ---
    lbufs, lv0, rays_l = paths.generate_light_path(scene, key_l, n,
                                                   cfg.light_depth, ids=pid)
    fb = jnp.zeros((splat_shape or n, 3), jnp.float32)
    rays_s = jnp.int32(0)
    if cfg.light_trace:
        fb, rays_s = light_trace_splat(scene, camera, lbufs, lv0, cfg, fb)

    # --- eye pass ---
    ebufs, ev0, esc, rays_e = paths.generate_eye_path(scene, camera, key_e,
                                                      px, py, cfg.eye_depth,
                                                      ids=pid)

    li = jnp.zeros((n, 3), jnp.float32)
    if cfg.sample_environment:
        # escape -> sky, MIS weight 1 (see module docstring)
        sky = common.sample_sky(esc.d, True)
        out = _weighted(esc.beta * sky, jnp.ones((n,), jnp.float32), cfg)
        li = li + jnp.where(esc.valid[:, None], out, 0.0)
    rays_c = jnp.int32(0)
    plane_area = _plane_area(camera)
    num_lights = max(scene.num_lights, 1)

    # The whole connection stage is a lax.scan over t (with a nested scan
    # over s for the general connections): compile time is O(1) in both
    # depths instead of O(E * L) — at the reference's shipped 16x10 the
    # unrolled form took minutes to compile.
    def connect_t(carry, t):
        li, rays_c = carry
        pick_e = lambda a: jax.lax.dynamic_index_in_dim(a, t - 2, axis=0,
                                                        keepdims=False)
        ev = dict(pt=pick_e(ebufs.pt), n=pick_e(ebufs.n), wo=pick_e(ebufs.wo),
                  uv=pick_e(ebufs.uv), beta=pick_e(ebufs.beta),
                  d_vcm=pick_e(ebufs.d_vcm), d_vc=pick_e(ebufs.d_vc),
                  is_delta=pick_e(ebufs.is_delta),
                  backface=pick_e(ebufs.backface),
                  light_ind=pick_e(ebufs.light_ind),
                  mat_id=pick_e(ebufs.mat_id), valid=pick_e(ebufs.valid))
        first_t = t == 2
        jprev = jnp.maximum(t - 3, 0)
        ev_prev_pt = jnp.where(first_t, ev0["pt"],
                               jax.lax.dynamic_index_in_dim(
                                   ebufs.pt, jprev, axis=0, keepdims=False))
        ev_prev_delta = first_t | jax.lax.dynamic_index_in_dim(
            ebufs.is_delta, jprev, axis=0, keepdims=False)
        mat_e = scene.materials.gather(ev["mat_id"])
        albedo_e = bsdf_ops.resolve_albedo(scene, mat_e, ev["uv"])
        trans_e = bsdf_ops.resolve_transmission(scene, mat_e, ev["uv"])

        # ---- s = 0: eye walk hit a light (deviceCode.cu:1552-1646) ----
        if cfg.naive:
            is_light = (ev["light_ind"] >= 0) & ~ev["backface"] & ev["valid"] \
                & ~ev["is_delta"]
            lidx = jnp.maximum(ev["light_ind"], 0)
            le = scene.light_emission[lidx]
            area = scene.light_area[lidx]
            cos_l = jnp.abs(dot(ev["n"], normalize(ev["wo"])))
            d2 = jnp.maximum(length_sq(ev["pt"] - ev_prev_pt), 1e-20)
            pdf_connect = (1.0 / num_lights) / jnp.maximum(area, 1e-20)
            # t == 2: weigh against the camera trace pdf (prev is the lens)
            cos_cam = jnp.abs(dot(jnp.broadcast_to(camera.forward,
                                                   ev["wo"].shape),
                                  -normalize(ev["wo"])))
            pdf_trace_cam = cos_l / (d2 * plane_area * cos_cam ** 3)
            w_eye_first = pdf_connect / jnp.maximum(pdf_trace_cam, 1e-20)
            # t > 2: recursive weight + firefly clamp
            pdf_c = jnp.where(ev_prev_delta, 0.0, pdf_connect)
            w_eye_gen = (pdf_c * ev["d_vcm"]
                         + pdf_c * (cos_l / PI) * ev["d_vc"])
            w_eye = jnp.where(first_t, w_eye_first, w_eye_gen)
            contrib = le * ev["beta"]
            lum = luminance(contrib)
            scale = jnp.where((lum > MAX_FIREFLY_LUM) & ~first_t,
                              MAX_FIREFLY_LUM / jnp.maximum(lum, 1e-20), 1.0)
            contrib = contrib * scale[:, None]
            weight = 1.0 / (1.0 + w_eye)
            out = _weighted(contrib, weight, cfg)
            li = li + jnp.where(is_light[:, None], out, 0.0)

        # ---- s = 1: NEE (deviceCode.cu:1479-1546) ----
        if cfg.nee and scene.num_lights > 0:
            do = ev["valid"] & ~ev["is_delta"]
            prev_to_curr = -ev["wo"]
            prev_to_curr_local = to_local(prev_to_curr, ev["n"])
            rays_c = rays_c + jnp.sum(do.astype(jnp.int32))
            ne = _bdpt_nee(scene, key_c, t, ev, mat_e, albedo_e,
                           prev_to_curr_local, do, ids=pid, trans_e=trans_e)

            pdf_bsdf_sa = bsdf_ops.bsdf_pdf(mat_e, -prev_to_curr_local,
                                            ne["stl_local"], ones,
                                            transmission=trans_e)
            pdf_bsdf_area = pdf_bsdf_sa * jnp.abs(ne["cos_light"]) / ne["d2"]
            w_light = pdf_bsdf_area / jnp.maximum(ne["pdf_connect"], 1e-20)

            pdf_curr_rev_area = (ne["pdf_emit_sa"]
                                 * jnp.abs(ne["stl_local"][..., 2]) / ne["d2"])
            pdf_prev_rev_sa = bsdf_ops.bsdf_pdf(mat_e, ne["stl_local"],
                                                -prev_to_curr_local, ones,
                                                transmission=trans_e)
            w_eye = pdf_curr_rev_area * (ev["d_vcm"]
                                         + pdf_prev_rev_sa * ev["d_vc"])
            weight = 1.0 / (1.0 + w_light + w_eye)
            contrib = ne["contrib"] * ev["beta"]
            out = _weighted(contrib, weight, cfg)
            li = li + jnp.where((do & ne["ok"])[:, None], out, 0.0)

        # ---- s >= 2: general connections (deviceCode.cu:1653-1763) ----
        if cfg.connection and cfg.light_depth >= 2:
            def connect_one(carry, j):
                li_acc, rays_acc = carry
                pick = lambda a: jax.lax.dynamic_index_in_dim(
                    a, j, axis=0, keepdims=False)
                lv = dict(pt=pick(lbufs.pt), n=pick(lbufs.n),
                          beta=pick(lbufs.beta), wo=pick(lbufs.wo),
                          uv=pick(lbufs.uv), d_vcm=pick(lbufs.d_vcm),
                          d_vc=pick(lbufs.d_vc),
                          is_delta=pick(lbufs.is_delta),
                          mat_id=pick(lbufs.mat_id),
                          valid=pick(lbufs.valid))
                mat_l = scene.materials.gather(lv["mat_id"])
                albedo_l = bsdf_ops.resolve_albedo(scene, mat_l, lv["uv"])
                trans_l = bsdf_ops.resolve_transmission(scene, mat_l,
                                                        lv["uv"])
                do = (ev["valid"] & lv["valid"] & ~ev["is_delta"]
                      & ~lv["is_delta"])

                e2l = lv["pt"] - ev["pt"]
                d2 = jnp.maximum(length_sq(e2l), RAY_EPSILON)
                dist = jnp.sqrt(d2)
                e2l_u = e2l / dist[:, None]
                cos_l = jnp.abs(dot(lv["n"], -e2l_u))
                cos_e = jnp.abs(dot(ev["n"], e2l_u))
                do = do & (cos_l > EPSILON) & (cos_e > EPSILON)

                origin = ev["pt"] + ev["n"] * RAY_EPSILON
                rays_acc = rays_acc + jnp.sum(do.astype(jnp.int32))
                shadow = traverse.shadow_factor(scene, origin, e2l_u,
                                                dist - RAY_EPSILON, active=do)
                do = do & (jnp.max(shadow, axis=-1) > 0.0)

                l2e_loc_l = to_local(-e2l_u, lv["n"])
                to_l_from_prev_loc = to_local(-lv["wo"], lv["n"])
                l2e_loc_e = to_local(-e2l_u, ev["n"])
                to_prev_loc_e = to_local(ev["wo"], ev["n"])

                # four reverse pdfs (map pdf_eval(A,B) -> bsdf_pdf(-A,B))
                pdf_eye_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_l, -to_l_from_prev_loc, l2e_loc_l, ones,
                    transmission=trans_l)
                pdf_eye_rev_area = pdf_eye_rev_sa * cos_e / d2
                pdf_bef_eye_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_e, -l2e_loc_e, to_prev_loc_e, ones,
                    transmission=trans_e)
                pdf_light_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_e, to_prev_loc_e, -l2e_loc_e, ones,
                    transmission=trans_e)
                pdf_light_rev_area = pdf_light_rev_sa * cos_l / d2
                pdf_bef_light_rev_sa = bsdf_ops.bsdf_pdf(
                    mat_l, l2e_loc_l, -to_l_from_prev_loc, ones,
                    transmission=trans_l)

                w_eye = pdf_eye_rev_area * (ev["d_vcm"]
                                            + pdf_bef_eye_rev_sa * ev["d_vc"])
                w_light = pdf_light_rev_area * (
                    lv["d_vcm"] + pdf_bef_light_rev_sa * lv["d_vc"])
                weight = 1.0 / (1.0 + w_eye + w_light)

                # f_eval(A, B) maps to bsdf_f(-A, B):
                # f_eye  = f_eval(lightToEye@eye, toPrevFromEye@eye)
                # f_light= f_eval(eyeToLight@light, toPrevFromLight@light)
                f_eye = bsdf_ops.bsdf_f(mat_e, albedo_e, -l2e_loc_e,
                                        to_prev_loc_e, ones,
                                        transmission=trans_e)
                f_light = bsdf_ops.bsdf_f(mat_l, albedo_l, l2e_loc_l,
                                          -to_l_from_prev_loc, ones,
                                          transmission=trans_l)

                g = jnp.minimum(cos_e * cos_l / d2, MAX_G_CONNECT)
                contrib = (ev["beta"] * lv["beta"] * f_eye * f_light
                           * g[:, None] * shadow)
                out = _weighted(contrib, weight, cfg)
                li_acc = li_acc + jnp.where(do[:, None], out, 0.0)
                return (li_acc, rays_acc), None

            (li, rays_c), _ = jax.lax.scan(
                connect_one, (li, rays_c),
                jnp.arange(cfg.light_depth - 1))  # s=2..L -> buffer j=0..L-2

        return (li, rays_c), None

    (li, rays_c), _ = jax.lax.scan(connect_t, (li, rays_c),
                                   jnp.arange(2, cfg.eye_depth + 1))

    rays = rays_l + rays_e + rays_s + rays_c
    if splat_shape is not None:
        return li, fb, rays
    return li + fb, rays
