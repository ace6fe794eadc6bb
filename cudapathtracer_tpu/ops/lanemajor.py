"""Lane-major shading pipeline for the persistent mega-wavefront.

Identical math to ops/bsdf.py + models/common.py + ops/traverse.shade_data
+ scene/camera.generate_rays, reorganized so every multi-component array
keeps the wavefront as its MINOR axis: vectors are [3,N], uv is [2,N], the
medium stack is [S,N], and the one shading gather is consumed transposed
as [64,N] — the layout rule of ops/traverse8.py. It was chosen for the
previous accelerator, whose vector registers padded a [N,3] elementwise
op's minor axis to 128 lanes; on the GPU the two layouts have not been
compared yet (ROADMAP Queue 3 item 2).

Only the reorganization is new: each function cites its row-major original,
and tests/test_lanemajor.py asserts numerical equivalence lane-by-lane.
The row-major originals remain the implementation for the classic
(per-bounce) integrators, whose shading stages run outside the hot
persistent loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops import bsdf as bsdf_ops
from cudapathtracer_tpu.scene.materials import (MAT_DELTAMIRROR, MAT_DIFFUSE,
                                                MAT_LEAF, MAT_METAL,
                                                MAT_SMOOTHDIELECTRIC,
                                                TRANSPORT_RADIANCE)
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import EPSILON, INV_PI, PI

# ---------------------------------------------------------------------------
# [3,N] vector substrate (utils/math.py ports)
# ---------------------------------------------------------------------------


def dotT(a, b):
    """[3,N]x[3,N] -> [N]."""
    return jnp.sum(a * b, axis=0)


def length_sqT(a):
    return jnp.sum(a * a, axis=0)


def normalizeT(a, eps: float = 1e-20):
    return a * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(a * a, axis=0, keepdims=True), eps))


def crossT(a, b):
    return jnp.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]], axis=0)


def luminanceT(c):
    """Rec.709 (util.cuh:283-286). c [3,N] -> [N]."""
    return c[0] * 0.2126 + c[1] * 0.7152 + c[2] * 0.0722


def build_frameT(n):
    """utils/math.build_frame on [3,N] normals -> (t, b) [3,N]."""
    nx, ny, nz = n[0], n[1], n[2]
    use_x = jnp.abs(nx) > jnp.abs(nz)
    inv_a = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny, 1e-20))
    ta = jnp.stack([-ny * inv_a, nx * inv_a, jnp.zeros_like(nx)], axis=0)
    inv_b = jax.lax.rsqrt(jnp.maximum(ny * ny + nz * nz, 1e-20))
    tb = jnp.stack([jnp.zeros_like(nx), -nz * inv_b, ny * inv_b], axis=0)
    t = jnp.where(use_x[None, :], ta, tb)
    b = crossT(n, t)
    return t, b


def to_localT(v, n):
    t, b = build_frameT(n)
    return jnp.stack([dotT(v, t), dotT(v, b), dotT(v, n)], axis=0)


def to_worldT(v, n):
    t, b = build_frameT(n)
    return v[0][None, :] * t + v[1][None, :] * b + v[2][None, :] * n


def safe_inv_dirT(d):
    """ops/intersect.safe_inv_dir on [3,N]."""
    s = jnp.where(d >= 0.0, 1.0, -1.0)
    return s / jnp.maximum(jnp.abs(d), 1e-30)


def _i32(col):
    return jax.lax.bitcast_convert_type(col, jnp.int32)


# ---------------------------------------------------------------------------
# Shade-row decode (ops/traverse.shade_data, lane-major)
# ---------------------------------------------------------------------------


class MatT(NamedTuple):
    """Per-lane material rows in lane-major layout ([N] / [3,N])."""
    type: jax.Array
    albedo: jax.Array        # [3,N]
    roughness: jax.Array
    eta: jax.Array           # [3,N]
    k: jax.Array             # [3,N]
    ior: jax.Array
    transmission: jax.Array
    is_specular: jax.Array
    boundary: jax.Array
    thin_walled: jax.Array
    absorption: jax.Array    # [3,N]
    priority: jax.Array
    tex_start: jax.Array
    tex_width: jax.Array
    tex_height: jax.Array
    trans_tex_start: jax.Array
    trans_tex_width: jax.Array
    trans_tex_height: jax.Array


def shade_dataT(scene, oT, dT, hit, point=None):
    """ONE packed-row gather -> (lane-major info dict, MatT rows).

    Lane-major port of ops/traverse.shade_data (row layout documented at
    scene/scene.py:_pack_shade_rows); oT/dT are [3,N]. `point` overrides
    the o + d*t hit-point computation (callers that saved the point
    earlier, e.g. the mega engine's early-NEE lanes, pass it so the
    floats are bit-identical to the original computation)."""
    tic = jnp.maximum(hit.tri, 0)
    rowT = scene.tri_shade_row[tic].T                    # THE gather [48,N]
    w0 = 1.0 - hit.u - hit.v
    n = (rowT[0:3] * w0[None, :] + rowT[3:6] * hit.u[None, :]
         + rowT[6:9] * hit.v[None, :])
    nrm = normalizeT(n)
    backface = dotT(nrm, dT) > 0.0
    nrm = jnp.where(backface[None, :], -nrm, nrm)
    uv = (rowT[9:11] * w0[None, :] + rowT[11:13] * hit.u[None, :]
          + rowT[13:15] * hit.v[None, :])
    ints = _i32(rowT[18:21])
    info = dict(
        point=point if point is not None else oT + dT * hit.t[None, :],
        normal=nrm,
        uv=uv,
        emission=rowT[15:18],
        light_ind=ints[0],
        mat_id=ints[1],
        backface=backface,
        valid=hit.valid,
        t=hit.t,
        tri=hit.tri,
        normal_a=rowT[0:3],
        area=rowT[46],
    )
    flags = _i32(rowT[33:36])
    texi = _i32(rowT[39:46])
    mat = MatT(
        type=ints[2],
        albedo=rowT[21:24],
        roughness=rowT[24],
        eta=rowT[25:28],
        k=rowT[28:31],
        ior=rowT[31],
        transmission=rowT[32],
        is_specular=flags[0] != 0,
        boundary=flags[1] != 0,
        thin_walled=flags[2] != 0,
        absorption=rowT[36:39],
        priority=texi[0],
        tex_start=texi[1],
        tex_width=texi[2],
        tex_height=texi[3],
        trans_tex_start=texi[4],
        trans_tex_width=texi[5],
        trans_tex_height=texi[6],
    )
    return info, mat


# ---------------------------------------------------------------------------
# Texture sampling (ops/bsdf.sample_texture, lane-major)
# ---------------------------------------------------------------------------


def sample_textureT(textures, start, width, height, uvT):
    """Bilinear, wrap addressing, flat atlas; uvT [2,N] -> [3,N]."""
    w = jnp.maximum(width, 1)
    h = jnp.maximum(height, 1)
    fx = uvT[0] * w - 0.5
    fy = uvT[1] * h - 0.5
    x0f = jnp.floor(fx)
    y0f = jnp.floor(fy)
    sx = (fx - x0f)[None, :]
    sy = (fy - y0f)[None, :]
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    y0 = jnp.mod(y0f.astype(jnp.int32), h)
    x1 = jnp.mod(x0 + 1, w)
    y1 = jnp.mod(y0 + 1, h)
    base = jnp.maximum(start, 0)
    c00 = textures[base + y0 * w + x0].T                 # [3,N] each
    c10 = textures[base + y0 * w + x1].T
    c01 = textures[base + y1 * w + x0].T
    c11 = textures[base + y1 * w + x1].T
    bottom = c00 * (1.0 - sx) + c10 * sx
    top = c01 * (1.0 - sx) + c11 * sx
    return bottom * (1.0 - sy) + top * sy


def resolve_albedoT(scene, mat: MatT, uvT):
    """ops/bsdf.resolve_albedo, lane-major -> [3,N]."""
    tex = sample_textureT(scene.textures, mat.tex_start, mat.tex_width,
                          mat.tex_height, uvT)
    has = (mat.tex_start >= 0)[None, :]
    return jnp.where(has, tex, mat.albedo)


def resolve_transmissionT(scene, mat: MatT, uvT):
    """ops/bsdf.resolve_transmission (reflectors.cuh:573-578), lane-major
    -> [N]."""
    if not getattr(scene, "has_trans_maps", True):
        return mat.transmission
    tex = sample_textureT(scene.textures, mat.trans_tex_start,
                          mat.trans_tex_width, mat.trans_tex_height, uvT)
    return jnp.where(mat.trans_tex_start >= 0, tex[0], mat.transmission)


# ---------------------------------------------------------------------------
# BSDF lobes (ops/bsdf.py ports; scalar [N] helpers are reused as-is)
# ---------------------------------------------------------------------------


def fresnel_conductorT(cos_theta, eta, k):
    """ops/bsdf.fresnel_conductor (Rs-only quirk kept); eta/k [3,N]."""
    c2 = (cos_theta * cos_theta)[None, :]
    s2 = 1.0 - c2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * cos_theta[None, :] * a
    return (t1 - t2) / (t1 + t2)


def cosine_fT(albedo):
    return albedo * INV_PI


def cosine_pdfT(wo):
    return jnp.maximum(wo[2], EPSILON) * INV_PI


def cosine_sampleT(u1, u2):
    u1 = jnp.minimum(u1, 1.0 - EPSILON)
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                      jnp.sqrt(1.0 - u1)], axis=0)


def ggx_sample_hT(u1, u2, alpha):
    phi = 2.0 * PI * u2
    cos_t = jnp.sqrt(jnp.maximum(
        (1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1), 0.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t],
                     axis=0)


def metal_fT(eta, k, roughness, wi, wo):
    """ops/bsdf.metal_f (reflectors.cuh:128-153); all dirs [3,N]."""
    valid = (wi[2] > 0.0) & (wo[2] > 0.0)
    h = normalizeT(wi + wo)
    h = jnp.where((h[2] <= 0.0)[None, :], -h, h)
    alpha = roughness * roughness
    d = bsdf_ops.d_ggx(h[2], alpha)
    g = bsdf_ops.g_smith(wi[2], wo[2], alpha)
    f = fresnel_conductorT(dotT(wi, h), eta, k)
    denom = jnp.maximum(4.0 * wi[2] * wo[2], EPSILON)
    val = (d * g / denom)[None, :] * f
    return jnp.where(valid[None, :], val, 0.0)


def metal_pdfT(roughness, wi, wo):
    h = normalizeT(wi + wo)
    d = bsdf_ops.d_ggx(h[2], roughness * roughness)
    denom = 4.0 * dotT(wo, h)
    sign = jnp.where(denom >= 0, 1.0, -1.0)
    return d * h[2] / (sign * jnp.maximum(jnp.abs(denom), 1e-8))


def mirror_fT(wo):
    return 1.0 / jnp.maximum(wo[2], EPSILON)


def dielectric_sampleT(u, wi, ior, backface, transport_mode):
    """ops/bsdf.dielectric_sample (reflectors.cuh:304-369), lane-major."""
    eta_i = jnp.where(backface, ior, 1.0)
    eta_t = jnp.where(backface, 1.0, ior)
    cos_i = jnp.clip(wi[2], EPSILON, 1.0)
    eta = eta_i / eta_t
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    fres = bsdf_ops.fresnel_schlick(cos_i, eta_i, eta_t)

    wo_refl = jnp.stack([-wi[0], -wi[1], wi[2]], axis=0)
    force_reflect = (cos_t2 < 0.0) | (fres >= 0.99999)

    wo_refr = jnp.stack([-eta * wi[0], -eta * wi[1],
                         -jnp.sqrt(jnp.maximum(cos_t2, 0.0))], axis=0)

    reflect = force_reflect | (u < fres)
    wo = jnp.where(reflect[None, :], wo_refl, wo_refr)

    f_refl = (jnp.where(force_reflect, 1.0, fres)
              / jnp.maximum(wo_refl[2], EPSILON))
    f_refr = (1.0 - fres) / jnp.maximum(jnp.abs(wo_refr[2]), EPSILON)
    if transport_mode == TRANSPORT_RADIANCE:
        f_refr = f_refr * eta * eta  # adjoint factor (reflectors.cuh:359-368)
    f = jnp.where(reflect, f_refl, f_refr)
    pdf = jnp.where(force_reflect, 1.0,
                    jnp.where(reflect, fres, 1.0 - fres))
    return wo, f, pdf


def leaf_fT(albedo, ior, curr_ior, roughness, transmission, wi, wo):
    """ops/bsdf.leaf_f (reflectors.cuh:420-543), lane-major."""
    is_refl = wo[2] * wi[2] > 0.0
    fres = bsdf_ops.fresnel_schlick(wi[2], curr_ior, ior)

    h = normalizeT(wi + wo)
    h = jnp.where((h[2] <= 0.0)[None, :], -h, h)
    mf = bsdf_ops.fresnel_schlick(dotT(wi, h), curr_ior, ior)
    alpha = roughness * roughness
    d = bsdf_ops.d_ggx(h[2], alpha)
    g = bsdf_ops.g_smith(wi[2], wo[2], alpha)
    denom = jnp.maximum(4.0 * wi[2] * wo[2], EPSILON)
    f_cuticle = (d * g * mf / denom)[None, :]
    f_refl = (((1.0 - mf) * (1.0 - transmission))[None, :]
              * cosine_fT(albedo) + f_cuticle)

    f_trans = cosine_fT(albedo) * (transmission * (1.0 - fres))[None, :]
    return jnp.where(is_refl[None, :], f_refl, f_trans)


def leaf_pdfT(ior, curr_ior, roughness, transmission, wi, wo):
    is_refl = wo[2] * wi[2] > 0.0
    fres = bsdf_ops.fresnel_schlick(jnp.abs(wi[2]), curr_ior, ior)
    fres = jnp.minimum(fres, 1.0 - 0.1 * roughness)  # reflectors.cuh:506
    p_spec = fres
    p_diff_refl = (1.0 - fres) * (1.0 - transmission)
    p_diff_trans = (1.0 - fres) * transmission

    pdf_cuticle = metal_pdfT(roughness, wi, wo)
    pdf_diffuse = cosine_pdfT(wo)
    pdf_refl = p_spec * pdf_cuticle + p_diff_refl * pdf_diffuse
    pdf_trans = cosine_pdfT(-wo) * p_diff_trans
    return jnp.where(is_refl, pdf_refl, pdf_trans)


def leaf_sampleT(u_sel, u_t, u1, u2, wi, ior, curr_ior, roughness, albedo,
                 transmission):
    fres = bsdf_ops.fresnel_schlick(wi[2], curr_ior, ior)
    h = ggx_sample_hT(u1, u2, roughness * roughness)
    wo_spec = 2.0 * dotT(wi, h)[None, :] * h - wi
    wo_cos = cosine_sampleT(u1, u2)
    wo_trans = wo_cos * jnp.asarray([1.0, 1.0, -1.0])[:, None]

    spec = u_sel < fres
    through = u_t < transmission
    wo = jnp.where(spec[None, :], wo_spec,
                   jnp.where(through[None, :], wo_trans, wo_cos))
    f = leaf_fT(albedo, ior, curr_ior, roughness, transmission, wi, wo)
    pdf = leaf_pdfT(ior, curr_ior, roughness, transmission, wi, wo)
    return wo, f, pdf


# ---------------------------------------------------------------------------
# Dispatch (ops/bsdf.bsdf_f / bsdf_pdf / bsdf_sample, lane-major)
# ---------------------------------------------------------------------------


# bitmask of material types a scene actually references (Scene.
# mat_type_mask): compute-all-and-select only pays for the lobes present.
# Skipping an absent lobe is bit-exact — no lane selects it.
ALL_LOBES = (1 << MAT_DIFFUSE) | (1 << MAT_METAL) \
    | (1 << MAT_SMOOTHDIELECTRIC) | (1 << MAT_LEAF) | (1 << MAT_DELTAMIRROR)


def bsdf_fT(mat: MatT, albedo, wi, wo, eta_i, transmission=None,
            lobe_mask: int = ALL_LOBES):
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    f = jnp.where((t == MAT_DIFFUSE)[None, :], cosine_fT(albedo), 0.0)
    if lobe_mask & (1 << MAT_METAL):
        f = jnp.where((t == MAT_METAL)[None, :],
                      metal_fT(mat.eta, mat.k, mat.roughness, wi, wo), f)
    if lobe_mask & (1 << MAT_LEAF):
        f = jnp.where((t == MAT_LEAF)[None, :],
                      leaf_fT(albedo, mat.ior, eta_i, mat.roughness,
                              trans, wi, wo), f)
    if lobe_mask & (1 << MAT_DELTAMIRROR):
        f = jnp.where((t == MAT_DELTAMIRROR)[None, :],
                      mirror_fT(wo)[None, :], f)
    return f


def bsdf_pdfT(mat: MatT, wi, wo, eta_i, transmission=None,
              lobe_mask: int = ALL_LOBES):
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    pdf = jnp.where(t == MAT_DIFFUSE, cosine_pdfT(wo), 0.0)
    if lobe_mask & (1 << MAT_METAL):
        pdf = jnp.where(t == MAT_METAL, metal_pdfT(mat.roughness, wi, wo),
                        pdf)
    if lobe_mask & (1 << MAT_LEAF):
        pdf = jnp.where(t == MAT_LEAF,
                        leaf_pdfT(mat.ior, eta_i, mat.roughness, trans,
                                  wi, wo), pdf)
    if lobe_mask & (1 << MAT_DELTAMIRROR):
        pdf = jnp.where(t == MAT_DELTAMIRROR, 1.0, pdf)
    return pdf


def bsdf_sampleT(key, draw_base, mat: MatT, albedo, wi, backface, eta_i,
                 transport_mode=TRANSPORT_RADIANCE, transmission=None,
                 ids=None, lobe_mask: int = ALL_LOBES, draws=None):
    """ops/bsdf.bsdf_sample, lane-major: (wo [3,N], f [3,N], pdf [N]).

    draws: optional precomputed (u_sel, u_t, u1, u2) uniforms [N] — callers
    whose draw keys vary PER LANE (the persistent light machine keys by
    each lane's own depth, models/light_mega.py) compute them via
    rng.uniform_keyed and pass them here; key/draw_base/ids are then
    unused."""
    n = wi.shape[1]
    if draws is not None:
        u_sel, u_t, u1, u2 = draws
    else:
        u_sel = rng.uniform_any(key, draw_base + 0, n, ids)
        u_t = rng.uniform_any(key, draw_base + 1, n, ids)
        u1 = rng.uniform_any(key, draw_base + 2, n, ids)
        u2 = rng.uniform_any(key, draw_base + 3, n, ids)
    t = mat.type
    trans = mat.transmission if transmission is None else transmission

    wo_d = cosine_sampleT(u1, u2)
    f_d = cosine_fT(albedo)
    pdf_d = cosine_pdfT(wo_d)

    def sel(cond, a, b):
        return jnp.where(cond[None, :] if a.ndim == 2 else cond, a, b)

    wo, f, pdf = wo_d, f_d, pdf_d

    if lobe_mask & (1 << MAT_METAL):
        h = ggx_sample_hT(u1, u2, mat.roughness * mat.roughness)
        wo_m = 2.0 * dotT(wi, h)[None, :] * h - wi
        wo_m = jnp.where((wo_m[2] <= 0.0)[None, :],
                         wo_m * jnp.asarray([1.0, 1.0, -1.0])[:, None], wo_m)
        f_m = metal_fT(mat.eta, mat.k, mat.roughness, wi, wo_m)
        pdf_m = metal_pdfT(mat.roughness, wi, wo_m)
        m = t == MAT_METAL
        wo, f, pdf = sel(m, wo_m, wo), sel(m, f_m, f), jnp.where(m, pdf_m,
                                                                 pdf)

    if lobe_mask & (1 << MAT_SMOOTHDIELECTRIC):
        wo_g, f_g, pdf_g = dielectric_sampleT(u_sel, wi, mat.ior, backface,
                                              transport_mode)
        m = t == MAT_SMOOTHDIELECTRIC
        wo = sel(m, wo_g, wo)
        f = sel(m, f_g[None, :] * jnp.ones((3, 1)), f)
        pdf = jnp.where(m, pdf_g, pdf)

    if lobe_mask & (1 << MAT_LEAF):
        wo_l, f_l, pdf_l = leaf_sampleT(u_sel, u_t, u1, u2, wi, mat.ior,
                                        eta_i, mat.roughness, albedo, trans)
        m = t == MAT_LEAF
        wo, f, pdf = sel(m, wo_l, wo), sel(m, f_l, f), jnp.where(m, pdf_l,
                                                                 pdf)

    if lobe_mask & (1 << MAT_DELTAMIRROR):
        wo_mi = jnp.stack([-wi[0], -wi[1], wi[2]], axis=0)
        f_mi = mirror_fT(wo_mi)
        m = t == MAT_DELTAMIRROR
        wo = sel(m, wo_mi, wo)
        f = sel(m, f_mi[None, :] * jnp.ones((3, 1)), f)
        pdf = jnp.where(m, jnp.ones((n,)), pdf)

    return wo, f, pdf


# ---------------------------------------------------------------------------
# Sky + NEE (models/common.py ports)
# ---------------------------------------------------------------------------


def power2_weight(p, q):
    """Scalar [N] power-2 MIS heuristic — layout-free, re-exported from
    models/common.py so lane-major callers need one import."""
    from cudapathtracer_tpu.models.common import power2_weight as _p2
    return _p2(p, q)


def sample_skyT(d, enabled: bool = False):
    """models/common.sample_sky on [3,N] -> [3,N]."""
    if not enabled:
        return jnp.zeros_like(d)
    unit = normalizeT(d)
    t = 0.5 * (unit[1] + 1.0)
    c_horizon = jnp.asarray([1.0, 0.4, 0.2])[:, None]
    c_zenith = jnp.asarray([0.3, 0.4, 0.8])[:, None]
    return (1.0 - t)[None, :] * c_horizon + t[None, :] * c_zenith


def nee_pdfT(scene, from_point, light_point, light_normal, light_area):
    """models/common.nee_pdf (deviceCode.cu:63-86), lane-major [3,N]."""
    stl = light_point - from_point
    wi = normalizeT(stl)
    d2 = length_sqT(stl)
    cos_l = dotT(light_normal, -wi)
    denom = cos_l * max(scene.num_lights, 1) * light_area
    sign = jnp.where(denom >= 0, 1.0, -1.0)
    return d2 / (sign * jnp.maximum(jnp.abs(denom), 1e-20))


class NEESampleT(NamedTuple):
    """models/common.NEESample in lane-major layout."""
    contrib: jax.Array    # [3,N]
    light_pdf: jax.Array  # [N]
    wo_local: jax.Array   # [3,N]
    origin: jax.Array     # [3,N]
    dir: jax.Array        # [3,N]
    max_t: jax.Array      # [N]
    active: jax.Array     # [N]


def sample_light_pointT(scene, key, draw_base, n, ids=None):
    """models/common.sample_light_point with the result transposed: returns
    (point [3,N], normal [3,N], emission [3,N], area [N], tri [N])."""
    from cudapathtracer_tpu.models import common

    ul = rng.uniform_any(key, draw_base + 0, n, ids)
    u = jnp.sqrt(rng.uniform_any(key, draw_base + 1, n, ids))
    v = rng.uniform_any(key, draw_base + 2, n, ids)
    num = max(scene.num_lights, 1)
    idx = jnp.minimum((ul * num).astype(jnp.int32), num - 1)
    rows = jnp.concatenate([
        scene.light_p0, scene.light_p1, scene.light_p2, scene.light_normal,
        scene.light_emission, scene.light_area[:, None],
        scene.light_tri.astype(jnp.float32)[:, None]], axis=1)
    r = (common.table_lookup(rows, idx) if num <= 64 else rows[idx]).T
    a, b, c = r[0:3], r[3:6], r[6:9]
    p = ((1.0 - u)[None, :] * a + (u * (1.0 - v))[None, :] * b
         + (u * v)[None, :] * c)
    return p, r[9:12], r[12:15], r[15], r[16].astype(jnp.int32)


def nee_sampleT(scene, key, draw_base, point, normal, wi_local, mat: MatT,
                albedo, eta_i, active, ids=None,
                transmission=None, lobe_mask: int = ALL_LOBES) -> NEESampleT:
    """models/common.nee_sample (deviceCode.cu:87-156 minus the shadow
    trace), lane-major."""
    from cudapathtracer_tpu.models.common import _safe

    n = point.shape[1]
    if scene.num_lights == 0:
        z = jnp.zeros((3, n), jnp.float32)
        return NEESampleT(z, jnp.full((n,), -1.0), z, point, z,
                          jnp.zeros((n,), jnp.float32),
                          jnp.zeros((n,), bool))

    lp, ln, le, larea, _ltri = sample_light_pointT(scene, key, draw_base, n,
                                                   ids)
    stl = lp - point
    wi = normalizeT(stl)
    dist = jnp.sqrt(jnp.maximum(length_sqT(stl), 0.0))

    origin = point + wi * EPSILON
    max_t = (dist - EPSILON) * (1.0 - EPSILON)

    light_pdf = nee_pdfT(scene, point, lp, ln, larea)
    cos_surf = jnp.abs(dotT(normal, wi))

    t, b = build_frameT(normal)
    wo_local = jnp.stack([dotT(wi, t), dotT(wi, b), dotT(wi, normal)],
                         axis=0)
    f_val = bsdf_fT(mat, albedo, -wi_local, wo_local, eta_i,
                    transmission=transmission, lobe_mask=lobe_mask)

    contrib = f_val * le * (cos_surf / _safe(light_pdf))[None, :]
    gate = (light_pdf > EPSILON) & active
    contrib = jnp.where(gate[None, :], contrib, 0.0)
    return NEESampleT(contrib, light_pdf, wo_local, origin, wi, max_t, gate)


# ---------------------------------------------------------------------------
# Medium stack (models/common.py MediumStack, lane-major [S,N])
# ---------------------------------------------------------------------------


class MediumStackT(NamedTuple):
    """models/common.MediumStack transposed: stack [S,N] packed
    (priority << 10 | mat_id), top [N]."""
    stack: jax.Array
    top: jax.Array

    @staticmethod
    def make(n: int, air_priority=0, size: int = 16) -> "MediumStackT":
        stack = jnp.zeros((size, n), jnp.int32)
        air = (jnp.asarray(air_priority, jnp.int32) << 10).astype(jnp.int32)
        stack = stack.at[0, :].set(air)
        return MediumStackT(stack=stack, top=jnp.ones((n,), jnp.int32))


def _pack_medium(mat_id, priority):
    return (priority.astype(jnp.int32) << 10) | mat_id


def stack_pushT(ms: MediumStackT, mat_id, priority, mask) -> MediumStackT:
    s = ms.stack.shape[0]
    slots = jnp.arange(s)[:, None]
    can = mask & (ms.top < s)
    put = can[None, :] & (slots == ms.top[None, :])
    stack = jnp.where(put, _pack_medium(mat_id, priority)[None, :], ms.stack)
    return MediumStackT(stack=stack, top=ms.top + can.astype(jnp.int32))


def stack_removeT(ms: MediumStackT, mat_id, mask) -> MediumStackT:
    """removeMaterialFromStack semantics (models/common.stack_remove)."""
    s = ms.stack.shape[0]
    slots = jnp.arange(s)[:, None]
    live = (slots > 0) & (slots < ms.top[None, :])
    match = ((ms.stack & 1023) == mat_id[None, :]) & live
    i_found = jnp.max(jnp.where(match, slots, -1), axis=0)
    found = (i_found >= 0) & mask
    shift_from = slots >= i_found[None, :]
    shifted = jnp.roll(ms.stack, -1, axis=0)
    stack = jnp.where(found[None, :] & shift_from, shifted, ms.stack)
    return MediumStackT(stack=stack, top=ms.top - found.astype(jnp.int32))


def dominant_mediumT(ms: MediumStackT):
    """models/common.dominant_medium: one min-reduce over axis 0."""
    s = ms.stack.shape[0]
    slots = jnp.arange(s)[:, None]
    live = slots < ms.top[None, :]
    packed = jnp.where(live, ms.stack, jnp.int32(2 ** 30))
    best = jnp.min(packed, axis=0)
    return best & 1023, best >> 10


def second_lowest_mediumT(ms: MediumStackT, exclude_mat):
    """models/common.second_lowest_medium (deviceCode.cu:397-420 quirks)."""
    s = ms.stack.shape[0]
    slots = jnp.arange(s)[:, None]
    live = slots < ms.top[None, :]
    consider = (live & ((ms.stack & 1023) != exclude_mat[None, :])
                & ((ms.stack >> 10) != 0))
    packed = jnp.where(consider, ms.stack, jnp.int32(2 ** 30))
    best = jnp.min(packed, axis=0)
    none_found = best == 2 ** 30
    return jnp.where(none_found, ms.stack[0] & 1023, best & 1023)


def table_lookup3T(col3, ids):
    """[M,3] material-constant column gathered by [N] ids -> [3,N]."""
    return col3[ids].T


# ---------------------------------------------------------------------------
# Camera (scene/camera.generate_rays, lane-major)
# ---------------------------------------------------------------------------


def generate_raysT(camera, key, px, py, ids=None):
    """scene/camera.Camera.generate_rays (objects.cuh:268-307), lane-major:
    px/py [N] float pixel coords -> (origins [3,N], dirs [3,N])."""
    import math as _math

    n = px.shape[0]
    jx = rng.uniform_any(key, 0, n, ids) - 0.5
    jy = rng.uniform_any(key, 1, n, ids) - 0.5
    aspect = camera.width / camera.height
    u = ((2.0 * (px + jx * camera.aa_jitter) / camera.width - 1.0)
         * aspect * camera.fov_scale)
    v = (2.0 * (py + jy * camera.aa_jitter) / camera.height
         - 1.0) * camera.fov_scale

    originC = jnp.reshape(camera.origin, (3, 1))
    rightC = jnp.reshape(camera.right, (3, 1))
    upC = jnp.reshape(camera.up, (3, 1))
    fwdC = jnp.reshape(camera.forward, (3, 1))

    focal = (originC + rightC * (u * camera.focal_dist)[None, :]
             + upC * (v * camera.focal_dist)[None, :]
             + fwdC * camera.focal_dist)

    r_rnd = rng.uniform_any(key, 2, n, ids)
    theta = 2.0 * _math.pi * rng.uniform_any(key, 3, n, ids)
    radius = camera.aperture * jnp.sqrt(r_rnd)
    lens = (rightC * (radius * jnp.cos(theta))[None, :]
            + upC * (radius * jnp.sin(theta))[None, :])
    lens = jnp.where(camera.aperture > 0.0, lens, 0.0)

    origin = originC + lens
    direction = normalizeT(focal - origin)
    return jnp.broadcast_to(origin, (3, n)), direction
