"""BSDF library: lobes + vectorized dispatch.

Re-design of reflectors.cuh for lockstep wavefront lanes: instead of a
per-thread switch on material type (reflectors.cuh:547-666), every lobe is
evaluated as batched math and the result is selected per-lane with jnp.where —
the compute-all-and-select pattern that keeps XLA fusion intact (lobes are
cheap elementwise arithmetic; only texture fetches gather).

Conventions (reflectors.cuh comments at 305, 546-549): local shading frame
with z = geometric-flipped normal; `wi` points AWAY from the surface
(wi.z > 0) — callers pass -ray_dir_local; `wo` is the sampled/evaluated
outgoing direction, wo.z < 0 meaning transmission. Intentional reference
quirks preserved (cited inline): Rs-only conductor Fresnel, Schlick dielectric
Fresnel, EPS-clamped cosine pdf, adjoint eta^2 only in radiance mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.scene.materials import (MAT_DELTAMIRROR, MAT_DIFFUSE,
                                                MAT_LEAF, MAT_METAL,
                                                MAT_SMOOTHDIELECTRIC,
                                                TRANSPORT_RADIANCE)
from cudapathtracer_tpu.utils import rng
from cudapathtracer_tpu.utils.math import EPSILON, INV_PI, PI, dot, normalize

# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


def fresnel_schlick(cos_theta, eta_i, eta_t):
    """Schlick approximation (reflectors.cuh:183-188); |cos| as reference."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - jnp.abs(cos_theta)) ** 5


def fresnel_conductor(cos_theta, eta, k):
    """Conductor Fresnel. NOTE(reference quirk, reflectors.cuh:107-126):
    returns the s-polarized term only — the (Rs+Rp)/2 average is commented
    out upstream; kept for image parity. cos_theta [N], eta/k [N,3]."""
    c2 = (cos_theta * cos_theta)[..., None]
    s2 = 1.0 - c2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * cos_theta[..., None] * a
    return (t1 - t2) / (t1 + t2)


# ---------------------------------------------------------------------------
# Lambertian (reflectors.cuh:10-57)
# ---------------------------------------------------------------------------


def cosine_f(albedo):
    return albedo * INV_PI


def cosine_pdf(wo):
    return jnp.maximum(wo[..., 2], EPSILON) * INV_PI


def cosine_sample(u1, u2):
    """Cosine-hemisphere warp; returns [N,3] with z>0."""
    u1 = jnp.minimum(u1, 1.0 - EPSILON)
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi),
                      jnp.sqrt(1.0 - u1)], axis=-1)


# ---------------------------------------------------------------------------
# GGX microfacet (reflectors.cuh:78-180)
# ---------------------------------------------------------------------------


def d_ggx(h_z, alpha):
    a2 = alpha * alpha
    denom = h_z * h_z * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def g1_ggx(v_z, alpha):
    """Rational G1 approximation (reflectors.cuh:92-101)."""
    v_z = jnp.maximum(jnp.abs(v_z), 1e-6)
    tan_t = jnp.sqrt(jnp.maximum(1.0 - v_z * v_z, 0.0)) / v_z
    a = 1.0 / jnp.maximum(alpha * tan_t, 1e-8)
    approx = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return jnp.where(a < 1.6, approx, 1.0)


def g_smith(wi_z, wo_z, alpha):
    return g1_ggx(wi_z, alpha) * g1_ggx(wo_z, alpha)


def ggx_sample_h(u1, u2, alpha):
    """Sample the GGX NDF half-vector (reflectors.cuh:160-172)."""
    phi = 2.0 * PI * u2
    cos_t = jnp.sqrt(jnp.maximum((1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1), 0.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def metal_f(eta, k, roughness, wi, wo):
    """[N,3] GGX conductor BRDF (reflectors.cuh:128-153)."""
    valid = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    h = normalize(wi + wo)
    h = jnp.where((h[..., 2] <= 0.0)[..., None], -h, h)
    alpha = roughness * roughness
    d = d_ggx(h[..., 2], alpha)
    g = g_smith(wi[..., 2], wo[..., 2], alpha)
    f = fresnel_conductor(dot(wi, h), eta, k)
    denom = jnp.maximum(4.0 * wi[..., 2] * wo[..., 2], EPSILON)
    val = (d * g / denom)[..., None] * f
    return jnp.where(valid[..., None], val, 0.0)


def metal_pdf(roughness, wi, wo):
    """NDF pdf = D*h.z/(4*dot(wo,h)) (reflectors.cuh:155-161); the reference
    has no guard on the denominator — we clamp its magnitude only."""
    h = normalize(wi + wo)
    d = d_ggx(h[..., 2], roughness * roughness)
    denom = 4.0 * dot(wo, h)
    sign = jnp.where(denom >= 0, 1.0, -1.0)
    return d * h[..., 2] / (sign * jnp.maximum(jnp.abs(denom), 1e-8))


# ---------------------------------------------------------------------------
# Mirror (reflectors.cuh:59-76)
# ---------------------------------------------------------------------------


def mirror_f(wo):
    return 1.0 / jnp.maximum(wo[..., 2], EPSILON)


# ---------------------------------------------------------------------------
# Smooth dielectric — sample only (delta lobe), reflectors.cuh:304-369
# ---------------------------------------------------------------------------


def dielectric_sample(u, wi, ior, backface, transport_mode):
    """The reference's `dumb_smooth_dielectric_sample_f`: Schlick Fresnel
    reflect/refract selection, TIR, adjoint eta^2 in radiance mode only.

    Returns (wo [N,3], f [N] scalar, pdf [N])."""
    eta_i = jnp.where(backface, ior, 1.0)
    eta_t = jnp.where(backface, 1.0, ior)
    cos_i = jnp.clip(wi[..., 2], EPSILON, 1.0)
    eta = eta_i / eta_t
    cos_t2 = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    fres = fresnel_schlick(cos_i, eta_i, eta_t)

    wo_refl = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)
    force_reflect = (cos_t2 < 0.0) | (fres >= 0.99999)

    wo_refr = jnp.stack([-eta * wi[..., 0], -eta * wi[..., 1],
                         -jnp.sqrt(jnp.maximum(cos_t2, 0.0))], axis=-1)

    reflect = force_reflect | (u < fres)
    wo = jnp.where(reflect[..., None], wo_refl, wo_refr)

    f_refl = jnp.where(force_reflect, 1.0, fres) / jnp.maximum(wo_refl[..., 2], EPSILON)
    f_refr = (1.0 - fres) / jnp.maximum(jnp.abs(wo_refr[..., 2]), EPSILON)
    if transport_mode == TRANSPORT_RADIANCE:
        f_refr = f_refr * eta * eta  # adjoint factor (reflectors.cuh:359-368)
    f = jnp.where(reflect, f_refl, f_refr)
    pdf = jnp.where(force_reflect, 1.0, jnp.where(reflect, fres, 1.0 - fres))
    return wo, f, pdf


# ---------------------------------------------------------------------------
# Layered leaf BSDF (reflectors.cuh:420-543)
# ---------------------------------------------------------------------------


def leaf_f(albedo, ior, curr_ior, roughness, transmission, wi, wo):
    is_refl = wo[..., 2] * wi[..., 2] > 0.0
    fres = fresnel_schlick(wi[..., 2], curr_ior, ior)

    # reflection side: GGX cuticle + diffuse, energy split by microfacet F
    h = normalize(wi + wo)
    h = jnp.where((h[..., 2] <= 0.0)[..., None], -h, h)
    mf = fresnel_schlick(dot(wi, h), curr_ior, ior)
    alpha = roughness * roughness
    d = d_ggx(h[..., 2], alpha)
    g = g_smith(wi[..., 2], wo[..., 2], alpha)
    denom = jnp.maximum(4.0 * wi[..., 2] * wo[..., 2], EPSILON)
    f_cuticle = (d * g * mf / denom)[..., None]
    f_refl = ((1.0 - mf) * (1.0 - transmission))[..., None] * cosine_f(albedo) + f_cuticle

    # transmission side: diffuse transmit scaled by (1-F)*transmission
    f_trans = cosine_f(albedo) * (transmission * (1.0 - fres))[..., None]
    return jnp.where(is_refl[..., None], f_refl, f_trans)


def leaf_pdf(ior, curr_ior, roughness, transmission, wi, wo):
    is_refl = wo[..., 2] * wi[..., 2] > 0.0
    fres = fresnel_schlick(jnp.abs(wi[..., 2]), curr_ior, ior)
    fres = jnp.minimum(fres, 1.0 - 0.1 * roughness)  # reflectors.cuh:506
    p_spec = fres
    p_diff_refl = (1.0 - fres) * (1.0 - transmission)
    p_diff_trans = (1.0 - fres) * transmission

    pdf_cuticle = metal_pdf(roughness, wi, wo)
    pdf_diffuse = cosine_pdf(wo)
    pdf_refl = p_spec * pdf_cuticle + p_diff_refl * pdf_diffuse
    pdf_trans = cosine_pdf(-wo) * p_diff_trans
    return jnp.where(is_refl, pdf_refl, pdf_trans)


def leaf_sample(u_sel, u_t, u1, u2, wi, ior, curr_ior, roughness, albedo,
                transmission):
    fres = fresnel_schlick(wi[..., 2], curr_ior, ior)
    h = ggx_sample_h(u1, u2, roughness * roughness)
    wo_spec = 2.0 * dot(wi, h)[..., None] * h - wi
    wo_cos = cosine_sample(u1, u2)
    wo_trans = wo_cos * jnp.asarray([1.0, 1.0, -1.0])

    spec = u_sel < fres
    through = u_t < transmission
    wo = jnp.where(spec[..., None], wo_spec,
                   jnp.where(through[..., None], wo_trans, wo_cos))
    f = leaf_f(albedo, ior, curr_ior, roughness, transmission, wi, wo)
    pdf = leaf_pdf(ior, curr_ior, roughness, transmission, wi, wo)
    return wo, f, pdf


# ---------------------------------------------------------------------------
# Texture sampling (reflectors.cuh:371-417)
# ---------------------------------------------------------------------------


def sample_texture(textures, start, width, height, uv):
    """Bilinear, wrap addressing, flat atlas. start/width/height: [N] i32;
    uv: [N,2]. Lanes with start < 0 return 0 (caller selects base albedo)."""
    w = jnp.maximum(width, 1)
    h = jnp.maximum(height, 1)
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0f = jnp.floor(fx)
    y0f = jnp.floor(fy)
    sx = (fx - x0f)[..., None]
    sy = (fy - y0f)[..., None]
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    y0 = jnp.mod(y0f.astype(jnp.int32), h)
    x1 = jnp.mod(x0 + 1, w)
    y1 = jnp.mod(y0 + 1, h)
    base = jnp.maximum(start, 0)
    c00 = textures[base + y0 * w + x0]
    c10 = textures[base + y0 * w + x1]
    c01 = textures[base + y1 * w + x0]
    c11 = textures[base + y1 * w + x1]
    bottom = c00 * (1.0 - sx) + c10 * sx
    top = c01 * (1.0 - sx) + c11 * sx
    return bottom * (1.0 - sy) + top * sy


def resolve_albedo(scene, mat, uv):
    """Base albedo with texture override where the material has one.
    (The reference's f_eval forgets the texture for diffuse — reflectors.cuh
    :569 uses mat.albedo — while sample_f_eval uses it; we use the textured
    albedo in both, the evident intent.)"""
    tex = sample_texture(scene.textures, mat.tex_start, mat.tex_width,
                         mat.tex_height, uv)
    has = (mat.tex_start >= 0)[..., None]
    return jnp.where(has, tex, mat.albedo)


def resolve_transmission(scene, mat, uv):
    """Transmission with transmission-map override (reflectors.cuh:573-578,
    600-610, 654-659: hasTransMap -> sampleTexture, red channel). The
    reference resolves this before every f/sample/pdf dispatch; integrators
    do the same via this helper. When the scene statically has no trans
    maps the texture fetch is elided (scene.has_trans_maps is a jit-static
    bool)."""
    if not getattr(scene, "has_trans_maps", True):
        return mat.transmission
    tex = sample_texture(scene.textures, mat.trans_tex_start,
                         mat.trans_tex_width, mat.trans_tex_height, uv)
    return jnp.where(mat.trans_tex_start >= 0, tex[..., 0], mat.transmission)


# ---------------------------------------------------------------------------
# Dispatch (reflectors.cuh:547-666) — compute-all-lobes-and-select
# ---------------------------------------------------------------------------


def bsdf_f(mat, albedo, wi, wo, eta_i, transmission=None):
    """Evaluate f for all lanes. mat: gathered MaterialTable rows [N].
    transmission: texture-resolved override (resolve_transmission); defaults
    to the material constant."""
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    f = jnp.where((t == MAT_DIFFUSE)[..., None], cosine_f(albedo), 0.0)
    f = jnp.where((t == MAT_METAL)[..., None],
                  metal_f(mat.eta, mat.k, mat.roughness, wi, wo), f)
    f = jnp.where((t == MAT_LEAF)[..., None],
                  leaf_f(albedo, mat.ior, eta_i, mat.roughness,
                         trans, wi, wo), f)
    f = jnp.where((t == MAT_DELTAMIRROR)[..., None], mirror_f(wo)[..., None], f)
    # smooth dielectric: delta lobe, f=0 for arbitrary directions
    return f


def bsdf_pdf(mat, wi, wo, eta_i, transmission=None):
    t = mat.type
    trans = mat.transmission if transmission is None else transmission
    pdf = jnp.where(t == MAT_DIFFUSE, cosine_pdf(wo), 0.0)
    pdf = jnp.where(t == MAT_METAL, metal_pdf(mat.roughness, wi, wo), pdf)
    pdf = jnp.where(t == MAT_LEAF,
                    leaf_pdf(mat.ior, eta_i, mat.roughness, trans,
                             wi, wo), pdf)
    pdf = jnp.where(t == MAT_DELTAMIRROR, 1.0, pdf)
    return pdf


def bsdf_sample(key, draw_base, mat, albedo, wi, backface, eta_i,
                transport_mode=TRANSPORT_RADIANCE, transmission=None,
                ids=None):
    """Sample wo for all lanes; returns (wo, f [N,3], pdf [N]).

    key/draw_base: rng stream position; consumes draws base..base+3.
    `ids`: stable per-lane ids for layout-independent sampling.
    """
    n = wi.shape[0]
    u_sel = rng.uniform_any(key, draw_base + 0, n, ids)
    u_t = rng.uniform_any(key, draw_base + 1, n, ids)
    u1 = rng.uniform_any(key, draw_base + 2, n, ids)
    u2 = rng.uniform_any(key, draw_base + 3, n, ids)
    t = mat.type
    trans = mat.transmission if transmission is None else transmission

    # diffuse
    wo_d = cosine_sample(u1, u2)
    f_d = cosine_f(albedo)
    pdf_d = cosine_pdf(wo_d)

    # metal
    h = ggx_sample_h(u1, u2, mat.roughness * mat.roughness)
    wo_m = 2.0 * dot(wi, h)[..., None] * h - wi
    wo_m = jnp.where((wo_m[..., 2] <= 0.0)[..., None],
                     wo_m * jnp.asarray([1.0, 1.0, -1.0]), wo_m)
    f_m = metal_f(mat.eta, mat.k, mat.roughness, wi, wo_m)
    pdf_m = metal_pdf(mat.roughness, wi, wo_m)

    # smooth dielectric
    wo_g, f_g, pdf_g = dielectric_sample(u_sel, wi, mat.ior, backface,
                                         transport_mode)

    # leaf
    wo_l, f_l, pdf_l = leaf_sample(u_sel, u_t, u1, u2, wi, mat.ior, eta_i,
                                   mat.roughness, albedo, trans)

    # mirror
    wo_mi = jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)
    f_mi = mirror_f(wo_mi)

    def sel(cond, a, b):
        return jnp.where(cond[..., None] if a.ndim == 2 else cond, a, b)

    wo = wo_d
    f = f_d
    pdf = pdf_d
    for tt, wo_c, f_c, pdf_c in (
            (MAT_METAL, wo_m, f_m, pdf_m),
            (MAT_SMOOTHDIELECTRIC, wo_g, f_g[..., None] * jnp.ones(3), pdf_g),
            (MAT_LEAF, wo_l, f_l, pdf_l),
            (MAT_DELTAMIRROR, wo_mi, f_mi[..., None] * jnp.ones(3),
             jnp.ones(n))):
        m = t == tt
        wo = sel(m, wo_c, wo)
        f = sel(m, f_c, f)
        pdf = jnp.where(m, pdf_c, pdf)

    return wo, f, pdf
