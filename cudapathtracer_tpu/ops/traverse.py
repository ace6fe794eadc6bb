"""Stackless wavefront BVH traversal — single-gather packed-row engine.

The wavefront replacement for the reference's per-thread stack walk
(BVHSceneIntersect / BVHShadowRay, integratorUtilities.cuh:84-288). All rays
in the wavefront advance one BVH node per traversal step inside one
`lax.while_loop`; per-lane state is a single int32 node cursor driven by
precomputed per-octant hit/miss links (scene/bvh.py), so there is no stack
and no divergence beyond masking.

Performance model (of the previous accelerator, where gather cost was per
ROW and almost independent of row width up to 128 floats): the entire
per-step working set — node AABB, all 16 octant links, leaf
triangle count, and the (≤K) inline leaf triangles with their ids — lives in
ONE packed row (Scene.node_packed) and each step issues exactly ONE gather.
Several steps are unrolled per while_loop iteration to amortize the loop's
fixed cost (condition reduction + scheduling).

Near-child-first ordering comes from the octant-indexed links; the closest-
hit loop additionally prunes nodes with tmin >= t_best (the reference omits
this pruning — pure win, identical results).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cudapathtracer_tpu.ops.intersect import (BIG_T, aabb_intersect,
                                              moller_trumbore, safe_inv_dir)
from cudapathtracer_tpu.utils.math import dot, normalize

LEAF_MAT_FLAG = 1 << 30

# Node-steps executed per while_loop iteration. Amortizes the loop's fixed
# per-iteration cost (tuned on the previous accelerator); CPU XLA's compile
# time explodes with the unrolled body, so tests dial it down via the
# environment.
import os as _os

STEPS_PER_ITER = int(_os.environ.get("TPT_STEPS_PER_ITER", "4"))

# Straggler compaction: traversal is lockstep, so the WORST lane's thread
# length bounds everyone's iteration count while most lanes idle (masked
# gathers still cost full bandwidth, which is the dominant per-step cost).
# Each level runs at full width only while the active count exceeds
# n/COMPACT_FRAC, then gathers survivors into an n/COMPACT_FRAC-wide state
# and recurses — so a wavefront that is already sparse (e.g. late Russian-
# roulette bounces) drops to a narrow width immediately.
COMPACT_FRAC = int(_os.environ.get("TPT_COMPACT_FRAC", "8"))
MIN_COMPACT_WIDTH = int(_os.environ.get("TPT_MIN_COMPACT_WIDTH", "8192"))


def _take_lanes(a, idx, n):
    """Gather lanes `idx` from a state array: along the LAST axis when that
    axis is the lane axis (lane-major arrays like the BVH8 stack [D,N] or
    [3,N] ray components), else along axis 0 ([N] / [N,3] arrays). The
    shape test is unambiguous because compaction only runs for
    n > MIN_COMPACT_WIDTH >> any minor dimension."""
    return a[..., idx] if a.shape[-1] == n else a[idx]


def _put_lanes(a, idx, b, n):
    return (a.at[..., idx].set(b) if a.shape[-1] == n
            else a.at[idx].set(b))


def _compacted_while(step, init, n):
    """Run `step` (state tuple of [N]-carrying arrays; state[0] = cursor,
    -1 = done) to completion using recursive straggler compaction."""
    if n <= MIN_COMPACT_WIDTH:
        def cond(s):
            return jnp.any(s[0] >= 0)

        def body(s):
            for _ in range(STEPS_PER_ITER):
                s = step(*s)
            return s
        return jax.lax.while_loop(cond, body, init)

    n_sub = n // COMPACT_FRAC

    def cond1(s):
        return jnp.sum((s[0] >= 0).astype(jnp.int32)) > n_sub

    def body1(s):
        for _ in range(STEPS_PER_ITER):
            s = step(*s)
        return s

    s = jax.lax.while_loop(cond1, body1, init)

    # compact stragglers (duplicate fill slots recompute lane idx[0] and
    # scatter identical values — harmless)
    idx = jnp.nonzero(s[0] >= 0, size=n_sub, fill_value=0)[0]
    sub = tuple(_take_lanes(a, idx, n) for a in s)
    sub = _compacted_while(step, sub, n_sub)
    return tuple(_put_lanes(a, idx, b, n) for a, b in zip(s, sub))


class Hit(NamedTuple):
    """Closest-hit record (pre-shading): all [N]."""
    t: jax.Array        # distance; == max_t on miss
    tri: jax.Array      # permuted triangle index, -1 on miss
    u: jax.Array        # barycentric weight of vertex b
    v: jax.Array        # barycentric weight of vertex c

    @property
    def valid(self):
        return self.tri >= 0


def _octant(d):
    o = (d[:, 0] < 0).astype(jnp.int32)
    o = o | ((d[:, 1] < 0).astype(jnp.int32) << 1)
    o = o | ((d[:, 2] < 0).astype(jnp.int32) << 2)
    return o


def _i32(col):
    return jax.lax.bitcast_convert_type(col, jnp.int32)


def _oct_select(cols8, oct8):
    """Select column oct8[n] from [N,8] without a gather: one-hot reduce
    (keeps everything as wide [N,8] elementwise ops — single-column
    extraction from a gathered array was pathologically slow on the
    previous accelerator)."""
    onehot = (jnp.arange(8, dtype=jnp.int32)[None, :] == oct8[:, None])
    return jnp.sum(jnp.where(onehot, cols8, 0), axis=1)


def closest_hit(scene, o, d, max_t=None, skip_tri=None, active=None) -> Hit:
    """Closest-hit traversal for a wavefront of rays.

    o, d: [N,3] (d normalized). max_t: scalar or [N]. skip_tri: [N] i32 or
    None (self-intersection exclusion). active: [N] bool lanes to trace.

    Dispatches on the scene's static `traversal` field: "bvh8" (default,
    ops/traverse8.py) or "threaded" (the binary engine below).
    """
    if getattr(scene, "traversal", "threaded") == "bvh8":
        from cudapathtracer_tpu.ops import traverse8
        return traverse8.closest_hit8(scene, o, d, max_t, skip_tri, active)
    n = o.shape[0]
    if max_t is None:
        max_t = jnp.full((n,), BIG_T, jnp.float32)
    else:
        max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (n,))
    if skip_tri is None:
        skip_tri = jnp.full((n,), -1, jnp.int32)
    inv_d = safe_inv_dir(d)
    oct8 = _octant(d)
    leaf_k = scene.max_leaf_size

    cur0 = jnp.zeros((n,), jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, -1)

    def step(cur, t_best, tri, u, v, o, d, inv_d, oct8, skip_tri):
        live = cur >= 0
        curc = jnp.maximum(cur, 0)

        # ONE gather, consumed via a handful of WIDE slices + reshapes —
        # XLA re-materialized the gather per distinct narrow slice on the
        # previous accelerator, so keep slices wide.
        row = scene.node_packed[curc]                   # [N, W]
        bounds = row[:, 0:6].reshape(-1, 2, 3)
        tmin, tmax, hit = aabb_intersect(o, inv_d, bounds[:, 0], bounds[:, 1])
        hit = hit & (tmin < t_best) & live

        links = _i32(row[:, 6:22]).reshape(-1, 2, 8)
        hit_link = _oct_select(links[:, 0], oct8)
        miss_link = _oct_select(links[:, 1], oct8)
        count = _i32(row[:, 22])
        is_leaf = count > 0

        tris = row[:, 24:24 + 9 * leaf_k].reshape(-1, leaf_k, 3, 3)
        ids = _i32(row[:, 24 + 9 * leaf_k: 24 + 10 * leaf_k])

        do_leaf = hit & is_leaf
        for k in range(leaf_k):
            tt, uu, vv, ok = moller_trumbore(o, d, tris[:, k, 0],
                                             tris[:, k, 1], tris[:, k, 2])
            tid = ids[:, k]
            tid = jnp.where(tid < 0, -1, tid & ~LEAF_MAT_FLAG)
            ok = ok & do_leaf & (tid >= 0) & (tt < t_best) & (tid != skip_tri)
            t_best = jnp.where(ok, tt, t_best)
            tri = jnp.where(ok, tid, tri)
            u = jnp.where(ok, uu, u)
            v = jnp.where(ok, vv, v)

        nxt = jnp.where(hit & ~is_leaf, hit_link, miss_link)
        cur = jnp.where(live, nxt, -1)
        return cur, t_best, tri, u, v, o, d, inv_d, oct8, skip_tri

    init = (cur0, max_t, jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32),
            o, d, inv_d, oct8, skip_tri)
    out = _compacted_while(step, init, n)
    return Hit(t=out[1], tri=out[2], u=out[3], v=out[4])


def shadow_factor(scene, o, d, max_t, skip_tri=None, active=None):
    """Any-hit shadow traversal with leaf-BSDF transmission
    (BVHShadowRay, integratorUtilities.cuh:188-288).

    Returns throughput scale [N,3]: 1 for clear, 0 for occluded, and
    albedo*transmission*(1-F_schlick) products for each MAT_LEAF surface
    crossed; a lane terminates early when max-component < 0.01. When the
    scene has no MAT_LEAF materials (static property), the transmission
    machinery compiles away entirely and occlusion is a pure boolean walk.
    """
    if getattr(scene, "traversal", "threaded") == "bvh8":
        from cudapathtracer_tpu.ops import traverse8
        return traverse8.shadow_factor8(scene, o, d, max_t, skip_tri, active)
    n = o.shape[0]
    max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (n,))
    if skip_tri is None:
        skip_tri = jnp.full((n,), -1, jnp.int32)
    inv_d = safe_inv_dir(d)
    oct8 = _octant(d)
    leaf_k = scene.max_leaf_size
    with_leaf = scene.has_leaf_materials

    cur0 = jnp.zeros((n,), jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, -1)

    def step(cur, scale, o, d, inv_d, oct8, max_t, skip_tri):
        live = cur >= 0
        curc = jnp.maximum(cur, 0)
        n = cur.shape[0]

        row = scene.node_packed[curc]
        bounds = row[:, 0:6].reshape(-1, 2, 3)
        tmin, tmax, hit = aabb_intersect(o, inv_d, bounds[:, 0], bounds[:, 1])
        hit = hit & (tmin < max_t) & live

        links = _i32(row[:, 6:22]).reshape(-1, 2, 8)
        hit_link = _oct_select(links[:, 0], oct8)
        miss_link = _oct_select(links[:, 1], oct8)
        count = _i32(row[:, 22])
        is_leaf = count > 0

        tris = row[:, 24:24 + 9 * leaf_k].reshape(-1, leaf_k, 3, 3)
        ids = _i32(row[:, 24 + 9 * leaf_k: 24 + 10 * leaf_k])

        do_leaf = hit & is_leaf
        blocked = jnp.zeros((n,), bool)
        for k in range(leaf_k):
            tt, uu, vv, ok = moller_trumbore(o, d, tris[:, k, 0],
                                             tris[:, k, 1], tris[:, k, 2])
            raw = ids[:, k]
            tid = jnp.where(raw < 0, -1, raw & ~LEAF_MAT_FLAG)
            ok = ok & do_leaf & ~blocked & (tid >= 0) & (tt < max_t) \
                & (tid != skip_tri)

            if with_leaf:
                is_leaf_mat = (raw >= 0) & ((raw & LEAF_MAT_FLAG) != 0)
                srow = scene.tri_shadow[jnp.maximum(tid, 0)]  # [N,16]
                n3 = srow[:, 0:9].reshape(-1, 3, 3)
                mat4 = srow[:, 9:13].reshape(-1, 4)  # albedo, transmission
                ior = srow[:, 13]
                w0 = 1.0 - uu - vv
                nrm = normalize(n3[:, 0] * w0[:, None] + n3[:, 1] * uu[:, None]
                                + n3[:, 2] * vv[:, None])
                cos_t = jnp.abs(dot(d, nrm))
                r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
                fres = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
                leaf_scale = (mat4[:, 0:3] * mat4[:, 3:4]
                              * (1.0 - fres)[:, None])
                pass_leaf = ok & is_leaf_mat
                scale = jnp.where(pass_leaf[:, None], scale * leaf_scale,
                                  scale)
                opaque = ok & ~is_leaf_mat
                dark = jnp.max(scale, axis=-1) < 0.01
                blocked = blocked | opaque | (pass_leaf & dark)
            else:
                blocked = blocked | ok
            scale = jnp.where(blocked[:, None], 0.0, scale)

        nxt = jnp.where(hit & ~is_leaf, hit_link, miss_link)
        nxt = jnp.where(blocked, -1, nxt)
        cur = jnp.where(live, nxt, -1)
        return cur, scale, o, d, inv_d, oct8, max_t, skip_tri

    init = (cur0, jnp.ones((n, 3), jnp.float32), o, d, inv_d, oct8, max_t,
            skip_tri)
    out = _compacted_while(step, init, n)
    return out[1]


def trace_fused(scene, o, d, t_lim, is_shadow, skip_tri=None, active=None):
    """Mixed closest-hit + shadow wavefront in one traversal loop.

    Lanes with is_shadow=False are closest-hit rays (t_lim = initial t_best,
    result in the returned Hit); lanes with is_shadow=True are any-hit shadow
    rays (t_lim = max_t, result in the returned scale [N,3]). The BVH8 engine
    runs both modes in one compacted loop, which averages the two
    populations' tail lengths; the threaded engine falls back to two calls.
    """
    if getattr(scene, "traversal", "threaded") == "bvh8":
        from cudapathtracer_tpu.ops import traverse8
        return traverse8.trace_fused8(scene, o, d, t_lim, is_shadow,
                                      skip_tri, active)
    n = o.shape[0]
    act = jnp.ones((n,), bool) if active is None else active
    hit = closest_hit(scene, o, d, max_t=t_lim, skip_tri=skip_tri,
                      active=act & ~is_shadow)
    scale = shadow_factor(scene, o, d, t_lim, skip_tri=skip_tri,
                          active=act & is_shadow)
    return hit, scale


def shade_data(scene, o, d, hit: Hit):
    """ONE packed-row gather -> (info dict, per-lane MaterialTable rows).

    Fused replacement for interpolate_hit + MaterialTable.gather: on the
    previous accelerator a random-row gather cost about the same at any
    width, so the ~13 per-field gathers they issue dominated shading cost;
    the packed
    Scene.tri_shade_row collapses them into one (layout in scene/scene.py).
    """
    from cudapathtracer_tpu.scene.materials import MaterialTable

    tic = jnp.maximum(hit.tri, 0)
    row = scene.tri_shade_row[tic]                      # THE gather [N,64]
    w0 = 1.0 - hit.u - hit.v
    n3 = row[:, 0:9].reshape(-1, 3, 3)
    nrm = normalize(n3[:, 0] * w0[:, None] + n3[:, 1] * hit.u[:, None]
                    + n3[:, 2] * hit.v[:, None])
    backface = dot(nrm, d) > 0.0
    nrm = jnp.where(backface[:, None], -nrm, nrm)
    uv3 = row[:, 9:15].reshape(-1, 3, 2)
    uv = (uv3[:, 0] * w0[:, None] + uv3[:, 1] * hit.u[:, None]
          + uv3[:, 2] * hit.v[:, None])
    ints = _i32(row[:, 18:21])
    info = dict(
        point=o + d * hit.t[:, None],
        normal=nrm,
        uv=uv,
        emission=row[:, 15:18],
        light_ind=ints[:, 0],
        mat_id=ints[:, 1],
        backface=backface,
        valid=hit.valid,
        t=hit.t,
        tri=hit.tri,
        normal_a=n3[:, 0],     # vertex-a normal: the reference's light
        area=row[:, 46],       # normal + area for the NEE counter-pdf
    )
    flags = _i32(row[:, 33:36])
    texi = _i32(row[:, 39:46])
    mat = MaterialTable(
        type=ints[:, 2],
        albedo=row[:, 21:24],
        roughness=row[:, 24],
        eta=row[:, 25:28],
        k=row[:, 28:31],
        ior=row[:, 31],
        transmission=row[:, 32],
        is_specular=flags[:, 0] != 0,
        boundary=flags[:, 1] != 0,
        thin_walled=flags[:, 2] != 0,
        absorption=row[:, 36:39],
        priority=texi[:, 0],
        tex_start=texi[:, 1],
        tex_width=texi[:, 2],
        tex_height=texi[:, 3],
        trans_tex_start=texi[:, 4],
        trans_tex_width=texi[:, 5],
        trans_tex_height=texi[:, 6],
    )
    return info, mat


def interpolate_hit(scene, o, d, hit: Hit):
    """Gather + interpolate shading data at hit points — the tail of
    BVHSceneIntersect (integratorUtilities.cuh:107-140).

    Returns dict with point/normal/uv/emission/mat_id/backface/valid.
    The normal is flipped toward the incoming ray; `backface` records the
    flip (for dielectric orientation).
    """
    tic = jnp.maximum(hit.tri, 0)
    w0 = 1.0 - hit.u - hit.v
    n3 = scene.tri_n[tic]
    nrm = normalize(n3[:, 0] * w0[:, None] + n3[:, 1] * hit.u[:, None]
                    + n3[:, 2] * hit.v[:, None])
    backface = dot(nrm, d) > 0.0
    nrm = jnp.where(backface[:, None], -nrm, nrm)

    uv3 = scene.tri_uv[tic]
    uv = (uv3[:, 0] * w0[:, None] + uv3[:, 1] * hit.u[:, None]
          + uv3[:, 2] * hit.v[:, None])

    return dict(
        point=o + d * hit.t[:, None],
        normal=nrm,
        uv=uv,
        emission=scene.tri_emission[tic],
        mat_id=scene.tri_mat[tic],
        light_ind=scene.tri_light[tic],
        backface=backface,
        valid=hit.valid,
        t=hit.t,
        tri=hit.tri,
    )
